"""Weight bridge: a flax variable tree -> a PyTorch ``state_dict``.

The port's modules carry the flax module and parameter names, so the bridge
only renames leaves and transposes dense kernels:

* ``kernel`` (Dense, [in, out]) -> ``weight`` = kernel.T;
* ``scale`` / ``bias`` (LayerNorm, BatchNorm) -> ``weight`` / ``bias``;
* ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``;
* ``bias``, ``queries``, ``wk``, ``in_proj_kernel``, ``in_proj_bias``, the
  graph-convolution matrices ``T``, ``S``, ``A`` and the PReLU slope
  ``prelu`` are copied as they are;
* any other leaf raises.

The tree is nested dicts of numpy arrays (``jax.device_get`` of the flax
variables); the bridge itself needs neither jax nor flax.

``torch_to_flax_variables`` goes back, for a module whose state dict came
this way: a 2-D ``weight`` is a dense kernel (transposed back), a 1-D one a
``scale``, ``running_mean`` / ``running_var`` land in ``batch_stats``.  It
lets a test hand both packages one training state, the projector's batch
statistics included.

``save_state_dict`` / ``load_state_dict`` keep a bridged ``state_dict`` in the
port's own checkpoint format, a plain `torch.save` of the dict, which the
entry points read (`cli/eval_smpl_short.py --diffusion_ckpt`).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Union

import numpy as np
import torch

_PARAM_NAMES = {"kernel": "weight", "scale": "weight"}
_PARAM_COPIED = {"bias", "queries", "wk", "in_proj_kernel", "in_proj_bias",
                 "T", "S", "A", "prelu"}
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
            if leaf not in names and (collection == "batch_stats"
                                      or leaf not in _PARAM_COPIED):
                raise ValueError(f"unknown {collection} leaf {path}")
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


def torch_to_flax_variables(state: Mapping[str, torch.Tensor]
                            ) -> Dict[str, Dict]:
    """A state dict of :func:`flax_to_torch_state_dict`'s naming ->
    ``{"params": ..., "batch_stats": ...}`` of nested dicts of numpy
    arrays; the inverse of that function."""
    stat_leaves = {v: k for k, v in _STAT_NAMES.items()}
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, tensor in state.items():
        module, _, leaf = key.rpartition(".")
        value = tensor.detach().cpu().numpy()
        if leaf in stat_leaves:
            collection, leaf = "batch_stats", stat_leaves[leaf]
        elif leaf == "weight" and value.ndim in (1, 2):
            collection = "params"
            leaf = "kernel" if value.ndim == 2 else "scale"
            value = value.T if value.ndim == 2 else value
        elif leaf in _PARAM_COPIED:
            collection = "params"
        else:
            raise ValueError(f"no flax leaf for {key}")
        node = out[collection]
        for part in module.split(".") if module else ():
            node = node.setdefault(part, {})
        node[leaf] = np.array(value, order="C")
    return out


def save_state_dict(path: Union[str, os.PathLike],
                    state: Mapping[str, torch.Tensor]) -> None:
    """Write ``state`` (name -> tensor) with `torch.save`, tensors on the
    CPU."""
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)


def load_state_dict(path: Union[str, os.PathLike], device=None
                    ) -> Dict[str, torch.Tensor]:
    """Read a file of :func:`save_state_dict` onto ``device`` (the CPU when
    not given).  ``weights_only=True``: nothing but tensors is unpickled."""
    state = torch.load(path, map_location=device or "cpu", weights_only=True)
    if not isinstance(state, dict) or not all(
            isinstance(v, torch.Tensor) for v in state.values()):
        raise ValueError(f"{path} does not hold a name -> tensor state dict")
    return state
