"""Dataset-path configuration files (`interdiff_tpu/data/paths.py`), the
reference's `data/cfg/BEHAVE.yml` / `HOI.yml` (`interdiff/data/
dataset_smpl.py:20-23`).

A config is a small YAML mapping.  Its keys are the reference's, either
spelling of the ones that drift between its README and its files:

    MOTION_PATH: /data/behave/sequences
    OBJECT_TEMPLATE: /data/behave/objects
    MODEL_PATH: /data/smplh            # dir with SMPLH_{male,female}.pkl
    SPLIT_PATH: /data/behave/split.json

Reading one needs PyYAML, imported only when a config is read.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass(frozen=True)
class DataPaths:
    motion_path: Optional[str] = None
    object_path: Optional[str] = None
    model_path: Optional[str] = None
    split_path: Optional[str] = None


def load_paths(config_file: str | Path) -> DataPaths:
    """The paths of a YAML config; raises ImportError naming PyYAML when it
    is not installed."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            f"reading the path config {config_file} needs the PyYAML "
            "package (import yaml), which is not installed; pass "
            "--motion_path and --model_path instead") from e

    with open(config_file) as f:
        raw = yaml.safe_load(f) or {}
    lower = {str(k).lower(): v for k, v in raw.items()}

    def get(*names):
        for n in names:
            if lower.get(n):
                return str(lower[n])
        return None

    return DataPaths(
        motion_path=get("motion_path", "sequences", "sequence"),
        object_path=get("object_template", "object_path", "objects"),
        model_path=get("model_path"),
        split_path=get("split_path"),
    )
