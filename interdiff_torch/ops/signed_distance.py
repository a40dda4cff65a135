"""Nearest-neighbour signed distance between point clouds
(`interdiff_tpu/ops/signed_distance.py`), the replacement for the
`chamfer_distance` extension behind `point2point_signed`
(`interdiff/tools.py:11-76`): hot in the correction gate, the metrics and
correction training.

The public functions route by device: a CUDA tensor launches the kernels of
`ops/nn.py` (K2, K3, K4) or raises, a CPU tensor takes their plain versions.
``nearest_neighbor``, ``signed_nearest`` and, through them,
``point2point_signed`` are differentiable on both devices (the `Function`s
of `ops/nn.py`); the pruned sweep is not, as in the JAX package.
Leading batch dimensions are flattened to the one batch axis the kernels
take, and a surface cloud shared across the batch is broadcast to it.

``chunk`` is kept in the signatures so that callers read as in the JAX
package, where it bounds the memory of the score matrix; here the kernels
keep no score matrix and the plain versions bound theirs by blocks of
frames, so it has no effect.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from interdiff_torch.ops import nn as _nn


def _flatten(a: torch.Tensor, *surfaces: torch.Tensor):
    """Collapse leading batch dims to one, broadcasting shared surface
    clouds across the batch; returns the contiguous flat tensors and an
    ``unflatten`` for per-query outputs."""
    if a.ndim < 2 or a.shape[-1] != 3:
        raise ValueError(f"queries must be [..., N, 3], got {tuple(a.shape)}")
    batch_shape = a.shape[:-2]
    flat = [a.reshape((-1,) + a.shape[-2:]).contiguous()]
    flat += [s.expand(batch_shape + s.shape[-2:])
             .reshape((-1,) + s.shape[-2:]).contiguous() for s in surfaces]

    def unflatten(x):
        return x.reshape(batch_shape + (a.shape[-2],))

    return flat, unflatten


def nearest_neighbor(a: torch.Tensor, b: torch.Tensor, *,
                     chunk: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(squared distance [..., N], index [..., N] int32) of the nearest
    b-point [..., M, 3] for every a-point [..., N, 3]: kernel K4."""
    (a3, b3), unflatten = _flatten(a, b)
    d, i = _nn.nearest_neighbor_diff(a3, b3)
    return unflatten(d), unflatten(i)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero (instead of infinite) gradient at x == 0: squared
    distances are clamped at 0, so ``sq == 0.0`` happens for touching
    geometry, and the gradient of sqrt there would poison every
    differentiated consumer.  The forward value is the exact sqrt."""
    positive = x > 0
    return torch.where(positive,
                       torch.sqrt(torch.where(positive, x, 1.0)), 0.0)


def signed_nearest(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor, *,
                   chunk: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused nearest neighbour + pseudonormal inside/outside test: kernel K3.

    a [..., N, 3] queries, b [..., M, 3] surface points, n [..., M, 3]
    vertex (pseudo)normals -> ``(sq_dist [..., N], sdot [..., N])`` with
    ``sdot = n[j*] . (a - b[j*])`` at the nearest b-point j*.  The signed
    distance of `point2point_signed` is ``sqrt(sq_dist) * sign(sdot)``.
    Differentiable in a, b and n."""
    (a3, b3, n3), unflatten = _flatten(a, b, n)
    d, s, _ = _nn.signed_nearest_diff(a3, b3, n3)
    return unflatten(d), unflatten(s)


def signed_nearest_pruned(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor,
                          *, delta: float = 0.25,
                          chunk: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`signed_nearest` that may skip far parts of the surface:
    kernel K2.

    Results are bit-equal to ``signed_nearest`` for every query whose
    nearest point is closer than ``delta``; every other query gets exactly
    ``(delta**2, +1.0)``.  Sound for consumers that use only the sign and
    the magnitude of negative (penetrating) distances, the correction gate
    and the `penetrate` metric, provided ``delta`` exceeds the body's
    largest interior-point-to-nearest-vertex distance (about 0.17 m for
    SMPL-scale meshes): a point farther than ``delta`` from every vertex is
    then outside.  Not differentiable; training keeps the full sweep."""
    (a3, b3, n3), unflatten = _flatten(a, b, n)
    fn = _nn.by_device(a3, _nn.signed_nearest_pruned_cuda,
                       _nn.signed_nearest_pruned_plain)
    d, s, _ = fn(a3, b3, n3, delta)
    return unflatten(d), unflatten(s)


def _gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [..., P, D], idx [..., Q] -> [..., Q, D]."""
    pick = idx.to(torch.int64).unsqueeze(-1).expand(
        idx.shape + (points.shape[-1],))
    return points.gather(-2, pick)


def point2point_signed(
    x: torch.Tensor,
    y: torch.Tensor,
    x_normals: Optional[torch.Tensor] = None,
    y_normals: Optional[torch.Tensor] = None,
    *,
    return_vector: bool = False,
    chunk: Optional[int] = 512,
):
    """Signed point-cloud distance, contract of `interdiff/tools.py:11-76`.

    x [..., P1, 3] (e.g. human verts), y [..., P2, 3] (e.g. object points).
    Returns (y2x_signed [..., P2], x2y_signed [..., P1], yidx_near,
    xidx_near [, y2x_vec, x2y_vec]): the distance from each y-point to its
    nearest x-point signed by ``x_normals`` (negative = behind the x
    surface), the same from x to y signed by ``y_normals``, the index into
    x nearest to each y and the index into y nearest to each x.
    """
    _, xidx_near = nearest_neighbor(x, y, chunk=chunk)  # nearest y per x
    _, yidx_near = nearest_neighbor(y, x, chunk=chunk)  # nearest x per y

    x2y = x - _gather(y, xidx_near)  # [..., P1, 3]
    y2x = y - _gather(x, yidx_near)  # [..., P2, 3]

    y2x_signed = torch.linalg.norm(y2x, dim=-1)
    if x_normals is not None:
        y_nn = _gather(x_normals, yidx_near)
        y2x_signed = y2x_signed * torch.sign((y_nn * y2x).sum(dim=-1))

    x2y_signed = torch.linalg.norm(x2y, dim=-1)
    if y_normals is not None:
        x_nn = _gather(y_normals, xidx_near)
        x2y_signed = x2y_signed * torch.sign((x_nn * x2y).sum(dim=-1))

    if return_vector:
        return y2x_signed, x2y_signed, yidx_near, xidx_near, y2x, x2y
    return y2x_signed, x2y_signed, yidx_near, xidx_near
