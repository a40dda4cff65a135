"""Checkpoints and the metrics stream of the trainers
(`interdiff_tpu/utils/train_io.py`).

``CheckpointManager`` keeps weights-only checkpoints as the port's own
state-dict files (`utils/convert.py::save_state_dict`), one ``step_<n>.pt``
per save plus ``index.json`` with each step's ``val_loss``; like the JAX
package's manager (orbax with ``best_fn``) it keeps the ``max_to_keep`` saves
with the lowest validation loss, the newer one at a tie.  Writes are
synchronous, so ``wait`` has nothing to wait for.  ``MetricsLogger`` appends
one JSON line per call.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from interdiff_torch.utils.convert import load_state_dict, save_state_dict


class CheckpointManager:
    """Best-``max_to_keep`` checkpointing of name -> tensor state dicts."""

    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max = max_to_keep
        self._index_path = os.path.join(self._dir, "index.json")
        self._index: Dict[int, float] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = {int(k): float(v)
                               for k, v in json.load(f).items()}

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def save(self, step: int, state: Mapping[str, torch.Tensor], *,
             val_loss: Optional[float] = None) -> None:
        save_state_dict(self._path(step), state)
        self._index[int(step)] = (float(val_loss) if val_loss is not None
                                  else float("inf"))
        # worst first: highest loss, then the older step
        ranked = sorted(self._index, key=lambda s: (-self._index[s], s))
        for old in ranked[:max(0, len(ranked) - self._max)]:
            os.remove(self._path(old))
            del self._index[old]
        with open(self._index_path, "w") as f:
            json.dump({str(k): v for k, v in sorted(self._index.items())}, f)

    def restore(self, step: Optional[int] = None, device=None
                ) -> Dict[str, torch.Tensor]:
        """The state dict saved at ``step`` (the latest when None)."""
        step = self.latest_step if step is None else step
        if step is None or step not in self._index:
            raise FileNotFoundError(f"no checkpoint for step {step} in "
                                    f"{self._dir}")
        return load_state_dict(self._path(step), device)

    @property
    def latest_step(self) -> Optional[int]:
        return max(self._index) if self._index else None

    def wait(self) -> None:
        """Saves are synchronous; kept so that callers read as in the JAX
        package."""


class MetricsLogger:
    """JSONL metrics stream; one line per log call."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any], **extra) -> None:
        row = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in {**metrics, **extra}.items():
            if isinstance(v, (str, bool)):
                row[k] = v
                continue
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
            v = np.asarray(v)
            row[k] = float(v) if v.ndim == 0 else v.tolist()
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def quartile_metrics(t: torch.Tensor, per_sample_loss: torch.Tensor,
                     num_timesteps: int) -> Dict[str, torch.Tensor]:
    """Per-diffusion-timestep-quartile loss logging
    (`train_diffusion_smpl.py:168-175`)."""
    quartile = (4 * t) // num_timesteps
    out = {}
    for q in range(4):
        mask = (quartile == q).to(torch.float32)
        out[f"q{q}"] = ((per_sample_loss * mask).sum()
                        / mask.sum().clamp(min=1.0))
    return out
