"""Point-cloud set-abstraction ops (`interdiff_tpu/ops/pointcloud.py`):
furthest-point sampling, ball query and grouping, in plain PyTorch.

Semantics of the `pointnet2_ops` kernels:

* ``furthest_point_sample`` seeds from point 0 and greedily adds the point
  that maximises the running min-distance; ties go to the lowest index.
* ``ball_query`` returns the first ``nsample`` in-radius point indices in
  index order; a short row repeats its first hit, a zero-hit row is index 0.
* grouping recenters xyz on the query center and puts it before the
  features.

Stage 1 of the PointNet++ encoder groups through the K1 kernel instead
(`ops/group.py`), whose plain version is ``query_and_group`` with the plain
gather; stage 2, whose 99-channel features do not fit that kernel, calls
``query_and_group`` directly.  ``query_and_group`` gathers narrow float32
rows through kernel K5 (`ops/gather.py`), as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from interdiff_torch.ops.gather import gather_rows, in_gate


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances a [..., N, 3], b [..., M, 3] -> [..., N, M], as
    |a|^2 + |b|^2 - 2ab clamped at 0."""
    aa = (a * a).sum(dim=-1)[..., :, None]
    bb = (b * b).sum(dim=-1)[..., None, :]
    ab = torch.matmul(a, b.transpose(-1, -2))
    return torch.clamp(aa + bb - 2.0 * ab, min=0.0)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Greedy FPS. xyz [B, N, 3] -> int64 indices [B, npoint]."""
    B, N, _ = xyz.shape
    min_d = torch.full((B, N), float("inf"), dtype=xyz.dtype,
                       device=xyz.device)
    last = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    picks = [last]
    for _ in range(npoint - 1):
        last_xyz = torch.gather(xyz, 1, last[:, None, None].expand(B, 1, 3))
        d = ((xyz - last_xyz) ** 2).sum(dim=-1)
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)  # first index among ties
        picks.append(last)
    return torch.stack(picks, dim=1)


def hierarchical_fps(xyz: torch.Tensor, npoint: int,
                     groups: int) -> torch.Tensor:
    """Grouped FPS: exact FPS inside each of ``groups`` strided partitions
    (group g holds points g, g + groups, ...), run in parallel.

    xyz [B, N, 3] with N and npoint divisible by ``groups`` -> int64
    indices [B, npoint] into the original order.
    """
    B, N, _ = xyz.shape
    if N % groups or npoint % groups:
        raise ValueError("N and npoint must be multiples of groups")
    per, k = N // groups, npoint // groups
    flat = xyz.reshape(B, per, groups, 3).transpose(1, 2).reshape(
        B * groups, per, 3)
    sub_idx = furthest_point_sample(flat, k).reshape(B, groups, k)
    orig = sub_idx * groups + torch.arange(
        groups, device=xyz.device)[None, :, None]
    return orig.reshape(B, npoint)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx int [B, ...] -> [B, ..., C]."""
    B = points.shape[0]
    batch = torch.arange(B, device=points.device).reshape(
        (B,) + (1,) * (idx.ndim - 1))
    return points[batch, idx]


def radius_sq(radius: float) -> float:
    """r^2 as the float32 value every selection compares against."""
    return float(np.float32(radius * radius))


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float,
               nsample: int, d2: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """First-``nsample``-within-radius indices, xyz [B, N, 3], new_xyz
    [B, M, 3] -> int64 [B, M, nsample].  ``d2``: optional precomputed
    ``pairwise_sqdist(new_xyz, xyz)`` shared across radii."""
    N = xyz.shape[1]
    if d2 is None:
        d2 = pairwise_sqdist(new_xyz, xyz)  # [B, M, N]
    mask = d2 < radius_sq(radius)
    # favour masked entries, then low index: top_k gives ascending j
    j = torch.arange(N, dtype=torch.float32, device=d2.device)
    score = torch.where(mask, -j, float("-inf"))
    idx = torch.topk(score, nsample, dim=-1).indices
    cnt = mask.sum(dim=-1, keepdim=True)
    valid = torch.arange(nsample, device=d2.device) < cnt
    idx = torch.where(valid, idx, idx[..., :1])
    return torch.where(cnt > 0, idx, torch.zeros_like(idx))


def query_and_group(xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: Optional[torch.Tensor], radius: float,
                    nsample: int, *,
                    d2: Optional[torch.Tensor] = None,
                    gather: Optional[Callable] = None) -> torch.Tensor:
    """`QueryAndGroup`, channels-last: xyz [B, N, 3], new_xyz [B, M, 3],
    features [B, N, C] | None -> [B, M, nsample, 3 + C] with the xyz
    recentered on each center.

    The rows are gathered by ``gather(data [B, N, C], idx [B, K])``; left
    out, float32 data of at most 8 channels goes through kernel K5
    (`ops/gather.py::gather_rows`) and anything else is indexed directly,
    the routing of `interdiff_tpu/ops/pallas_gather.py::gather_rows`."""
    idx = ball_query(xyz, new_xyz, radius, nsample, d2)
    data = xyz if features is None else torch.cat([xyz, features], dim=-1)
    if gather is None:
        gather = gather_rows if in_gate(data) else gather_points
    B, M, S = idx.shape
    g = gather(data, idx.reshape(B, M * S)).reshape(B, M, S, -1)
    return torch.cat([g[..., :3] - new_xyz[:, :, None, :], g[..., 3:]],
                     dim=-1)
