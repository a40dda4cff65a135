"""Seeded weights for a module of the program, made on its device by one
`torch.Generator` in two large draws (normal and uniform) and cut into
every tensor of its state dict at the scale of the modules' own
initialisers."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def seeded_state(module: torch.nn.Module, seed: int
                 ) -> Dict[str, torch.Tensor]:
    ref = module.state_dict()
    device = next(iter(ref.values())).device
    total = sum(t.numel() for t in ref.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    state, at = {}, 0
    for name, t in ref.items():
        shape, n, leaf = tuple(t.shape), t.numel(), name.rsplit(".", 1)[-1]
        z = normal[at:at + n].reshape(shape)
        u = uniform[at:at + n].reshape(shape)
        at += n
        if leaf == "running_var":
            v = 0.5 + u
        elif leaf == "running_mean":
            v = 0.1 * z
        elif leaf == "weight" and len(shape) == 1:  # LayerNorm, BatchNorm
            v = 1.0 + 0.1 * z
        elif leaf in ("bias", "in_proj_bias"):
            v = 0.02 * z
        elif leaf == "weight":  # Linear [out, in]
            v = z / np.sqrt(shape[1])
        elif leaf in ("in_proj_kernel", "wk"):  # [in, ...]
            v = z / np.sqrt(shape[0])
        elif leaf in ("queries", "T", "S", "A"):  # [..., N, D]
            v = z / np.sqrt(shape[-1])
        elif leaf == "prelu":
            v = torch.full(shape, 0.25, device=device)
        else:
            raise KeyError(f"no seeded initialiser for {name}")
        state[name] = v.contiguous()
    return state


def rest_pose(state: dict, smpl_dim: int, obj_offset) -> None:
    """An untrained denoiser puts the object metres from the body, where
    the gate's sweep has nothing to do.  Its two output layers are scaled
    to a twentieth and biased to the rest pose, with the object at
    ``obj_offset`` from the body's centre, so that the denoised frames
    scatter about an object that straddles the body's surface."""
    eye6 = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    for layer, bias in (("bodyFinalLinear", eye6 * (smpl_dim // 6)
                         + [0.0, 0.0, 0.0]),
                        ("objFinalLinear", eye6 + list(obj_offset))):
        w = state[layer + ".weight"]
        state[layer + ".weight"] = w * 0.05
        state[layer + ".bias"] = torch.tensor(bias, dtype=w.dtype,
                                              device=w.device)
