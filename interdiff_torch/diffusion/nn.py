"""Helpers around the diffusion trainers (`interdiff_tpu/diffusion/nn.py`):

* ``timestep_embedding``: the sinusoidal embedding with the cos half first
  and the sin half second (not the positional table the MDM itself uses);
* ``update_ema``, ``zero_params``, ``scale_params``: over the tensors of a
  parameter collection, a name -> tensor mapping (a state dict, the
  trainer's ``params``) or a sequence of tensors, updated in place;
* ``mean_flat``, ``sum_flat``: reductions over every axis but the batch's.

Gradient checkpointing (`jax.checkpoint` there) has no user in the port.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Mapping, Union

import torch

Params = Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]]


def _tensors(params: Params) -> List[torch.Tensor]:
    return list(params.values() if isinstance(params, Mapping) else params)


def mean_flat(tensor: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return tensor.mean(dim=tuple(range(1, tensor.ndim)))


def sum_flat(tensor: torch.Tensor) -> torch.Tensor:
    """Sum over all non-batch axes."""
    return tensor.sum(dim=tuple(range(1, tensor.ndim)))


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embeddings [N] -> [N, dim] (cos | sin halves,
    zero-padded when dim is odd)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.to(torch.float32)[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


@torch.no_grad()
def update_ema(ema_params: Params, params: Params, *,
               rate: float = 0.9999) -> Params:
    """ema <- ema * rate + p * (1 - rate), in place on ``ema_params`` (two
    fused passes over all tensors); ``params`` is matched by order."""
    ema, new = _tensors(ema_params), _tensors(params)
    if len(ema) != len(new):
        raise ValueError(f"{len(ema)} shadow tensors, {len(new)} parameters")
    if ema:
        torch._foreach_mul_(ema, rate)
        torch._foreach_add_(ema, [p.detach() for p in new], alpha=1.0 - rate)
    return ema_params


@torch.no_grad()
def zero_params(params: Params) -> Params:
    """Zero every tensor in place (`zero_module`)."""
    for p in _tensors(params):
        p.zero_()
    return params


@torch.no_grad()
def scale_params(params: Params, scale: float) -> Params:
    """Scale every tensor in place (`scale_module`)."""
    for p in _tensors(params):
        p.mul_(scale)
    return params
