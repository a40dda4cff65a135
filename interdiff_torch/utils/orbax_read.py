"""Read an orbax save of the JAX package without JAX, orbax or tensorstore:
the counterpart of `interdiff_tpu/cli/common.py::restore_params` with
``template=None``.

Two layouts are read:

* a flat ``StandardCheckpointer`` save (``artifacts/*_params``):
  ``_METADATA`` (JSON; ``tree_metadata`` maps each leaf to its key path),
  ``manifest.ocdbt`` and the OCDBT store under it (`utils/ocdbt.py`), one
  zarr v2 array a leaf, named by its key path joined with '.';
* a ``CheckpointManager`` directory, as `interdiff_tpu/utils/train_io.py`
  writes it: numeric step directories, each with ``_CHECKPOINT_METADATA``
  and the save in its ``default`` item; the latest step is read.

Only ``np.ndarray`` leaves are read (what the JAX package saves, every
tree passing through ``jax.device_get``); any other value type raises and
names it.  A directory that is neither layout raises `ValueError`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from interdiff_torch.utils.ocdbt import OcdbtStore, read_array

_DICT_KEY, _SEQUENCE_KEY = 2, 1  # orbax's KeyType


def latest_step(path: str) -> Optional[int]:
    """The latest finished step of a ``CheckpointManager`` directory (a
    numeric directory holding ``_CHECKPOINT_METADATA``), or None."""
    steps = [int(name) for name in os.listdir(path) if name.isdigit()
             and os.path.isfile(os.path.join(path, name,
                                             "_CHECKPOINT_METADATA"))]
    return max(steps, default=None)


def _save_dir(path: str) -> str:
    if os.path.isfile(os.path.join(path, "_METADATA")):
        return path
    step = latest_step(path)
    if step is None:
        raise ValueError(
            f"{path} is not an orbax save: no _METADATA (a flat "
            "StandardCheckpointer save) and no finished numeric step "
            "directory (a CheckpointManager directory)")
    save = os.path.join(path, str(step), "default")
    if not os.path.isfile(os.path.join(save, "_METADATA")):
        raise ValueError(f"{path}: step {step} has no 'default' item with "
                         "_METADATA")
    return save


def _nest(leaves: Dict[tuple, np.ndarray]) -> Dict[str, Any]:
    """Key paths of (key, is sequence index) pairs -> nested dicts, a node
    whose keys are sequence indices a list in index order."""
    root: Dict = {}
    sequences = set()  # ids of the nodes keyed by sequence indices
    for path, value in leaves.items():
        node = root
        for depth, (key, is_seq) in enumerate(path):
            if is_seq:
                sequences.add(id(node))
            if depth == len(path) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        out = {k: build(v) for k, v in node.items()}
        if id(node) not in sequences:
            return out
        keys = sorted(out, key=int)
        if [int(k) for k in keys] != list(range(len(keys))):
            raise ValueError(f"sequence indices {keys} are not 0..n-1")
        return [out[k] for k in keys]

    return build(root)


def restore(path: str) -> Dict[str, Any]:
    """The saved tree at ``path`` (a flat save or a ``CheckpointManager``
    directory at its latest step): nested dicts (lists for sequences) of
    numpy arrays, each leaf's dtype and shape as saved."""
    path = os.path.abspath(path)
    save = _save_dir(path)
    with open(os.path.join(save, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{save}: use_ocdbt={meta.get('use_ocdbt')}, "
                         f"use_zarr3={meta.get('use_zarr3')}: only OCDBT "
                         "saves of zarr v2 arrays are read")
    store = OcdbtStore(save)
    leaves = {}
    for name, entry in meta["tree_metadata"].items():
        value = entry["value_metadata"]
        kind = value.get("value_type")
        if kind != "np.ndarray":
            raise ValueError(f"{save}: leaf {name} has value type {kind!r}: "
                             "only np.ndarray leaves are read")
        if value.get("skip_deserialize", False):
            raise ValueError(f"{save}: leaf {name} is saved as "
                             "skip_deserialize, without its value")
        keys = entry["key_metadata"]
        if any(k["key_type"] not in (_DICT_KEY, _SEQUENCE_KEY)
               for k in keys):
            raise ValueError(f"{save}: leaf {name} has a key type other "
                             "than dict key or sequence index")
        path_keys = tuple((str(k["key"]), k["key_type"] == _SEQUENCE_KEY)
                          for k in keys)
        leaves[path_keys] = read_array(
            store, ".".join(k for k, _ in path_keys))
    return _nest(leaves)
