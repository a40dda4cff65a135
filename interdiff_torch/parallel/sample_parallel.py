"""Diverse-sample (best-of-N) batching (`interdiff_tpu/parallel/sample_parallel.py`):
the N independent stochastic samples of a clip are folded into the batch
axis, so one sampler call covers them all; and the sampler over a data mesh
(:func:`data_parallel_sample`)."""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from interdiff_torch.parallel.mesh import (
    DataMesh,
    all_gather_rows,
    shard_batch,
    use_mesh,
)


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


def _place(batch, device):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_place(x, device) for x in batch)
    if isinstance(batch, dict):
        return {k: _place(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    return batch.to(device)


def data_parallel_sample(sample_fn: Callable, mesh: Optional[DataMesh], *,
                         out_sharded: bool = True) -> Callable:
    """``sample_fn(*rows, **kwargs)`` (a sampler or an eval function) run on
    this rank's rows under the mesh (`parallel/mesh.py::use_mesh`).

    Per-sequence sampling couples no rows, so it needs no collective: each
    rank samples its own rows, and every draw from the shared generator is
    made for the global batch and cut to the rank's rows, so that a row's
    sample equals the one-rank sample of the whole batch.  The arguments,
    explicit ``noise`` and ``step_noise`` included, are the rank's rows
    (``.place_batch(global batch)`` makes them, on the rank's device).
    Returns the rank's rows of the output or, with ``out_sharded=False``,
    every rank's in row order on every rank."""

    def run(*args, **kwargs):
        with use_mesh(mesh):
            out = sample_fn(*args, **kwargs)
        return out if out_sharded else all_gather_rows(out, mesh)

    run.place_batch = lambda batch: _place(shard_batch(batch, mesh),
                                           mesh.device if mesh is not None
                                           else None)
    return run
