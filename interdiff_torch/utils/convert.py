"""Weight bridge: a flax variable tree -> a PyTorch ``state_dict``.

The port's modules carry the flax module and parameter names, so the bridge
only renames leaves and transposes dense kernels:

* ``kernel`` (Dense, [in, out]) -> ``weight`` = kernel.T;
* ``scale`` / ``bias`` (LayerNorm, BatchNorm) -> ``weight`` / ``bias``;
* ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
* every other leaf (``queries``, ``wk``, ``in_proj_kernel``,
  ``in_proj_bias``) is copied as it is.

The tree is nested dicts of numpy arrays (``jax.device_get`` of the flax
variables); the bridge itself needs neither jax nor flax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_NAMES = {"kernel": "weight", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def flax_to_torch_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` -> ``state_dict`` keys.

    Raises on a leaf the rules do not cover and on two leaves that land on
    the same key, so every flax leaf maps to exactly one tensor.
    """
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unsupported flax collections: {sorted(unknown)}")
    out: Dict[str, torch.Tensor] = {}
    for collection, names in (("params", _PARAM_NAMES),
                              ("batch_stats", _STAT_NAMES)):
        for path, value in _flatten(variables.get(collection, {})):
            module, _, leaf = path.rpartition(".")
            if collection == "batch_stats" and leaf not in names:
                raise ValueError(f"unknown batch_stats leaf {path}")
            if leaf == "kernel":
                if value.ndim != 2:
                    raise ValueError(f"dense kernel {path} is not 2-D")
                value = value.T
            key = f"{module}.{names.get(leaf, leaf)}" if module else \
                names.get(leaf, leaf)
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = torch.from_numpy(np.array(value, order="C"))
    return out
