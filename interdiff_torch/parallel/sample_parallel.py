"""Diverse-sample (best-of-N) batching (`interdiff_tpu/parallel/sample_parallel.py`):
the N independent stochastic samples of a clip are folded into the batch
axis, so one sampler call covers them all."""

from __future__ import annotations

from typing import Dict

import torch


def tile_for_diverse_samples(batch, n: int):
    """Repeat the batch dim of a tensor, or of each tensor of a tuple/list,
    n times: [B, ...] -> [n*B, ...] (sample i of clip b lands at row
    i*B + b)."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(tile_for_diverse_samples(x, n) for x in batch)
    return batch.repeat((n,) + (1,) * (batch.ndim - 1))


def split_diverse_samples(x: torch.Tensor, n: int) -> torch.Tensor:
    """[n*B, ...] -> [n, B, ...]."""
    return x.reshape((n, -1) + tuple(x.shape[1:]))


def best_of_n_metrics(metrics: Dict[str, torch.Tensor], n: int
                      ) -> Dict[str, torch.Tensor]:
    """Per-sample metric dict over a tiled batch [n*B] -> the minimum over
    the n samples of each clip [B] (the reference's `.min(dim=0)`)."""
    return {k: split_diverse_samples(v, n).amin(dim=0)
            for k, v in metrics.items()}
