"""PointNet++ multi-scale-grouping encoder (`interdiff_tpu/models/pointnet.py`),
channels-last: clouds are [B, P, 3 + C] and the shared MLPs are 1x1 convs,
i.e. bias-free Linear layers over the channel axis.

Stage 1 (4 data channels) groups through kernel K1 (`ops/group.py`), which
runs on the card for a CUDA tensor; stage 2 (99 channels, one center) uses
plain `query_and_group`.  With the environment variable
``INTERDIFF_FUSED_SA`` set (the JAX package reads the same one), a narrow
stage runs each radius scale whole through kernel K6 (`ops/sa.py`) instead
of K1 + `SharedMLP` + ``amax``.  BatchNorm runs in inference mode on its
running statistics; train-mode BatchNorm is not ported yet.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from interdiff_torch.models.layers import BatchNormEval
from interdiff_torch.ops.group import MAX_C, fused_query_group, pairwise_sqdist_t
from interdiff_torch.ops.pointcloud import (
    furthest_point_sample,
    gather_points,
    hierarchical_fps,
    pairwise_sqdist,
    query_and_group,
)
from interdiff_torch.ops.sa import folded_affine, fused_sa_scale


class SharedMLP(nn.Module):
    """conv{i} (1x1, no bias) -> bn{i} -> ReLU chain over the channel axis
    (`pointnet2_ops` `build_shared_mlp`), x [B, M, S, C]."""

    def __init__(self, c_in: int, channels: Sequence[int]):
        super().__init__()
        self.depth = len(channels)
        for i, c in enumerate(channels):
            self.add_module(f"conv{i}", nn.Linear(c_in, c, bias=False))
            self.add_module(f"bn{i}", BatchNormEval(c))
            c_in = c

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            x = torch.relu(x)
        return x


class SAModuleMSG(nn.Module):
    """`PointnetSAModuleMSG`: FPS centers, per-radius ball-query grouping,
    shared MLP, max over neighbours, concat over scales."""

    def __init__(self, c_in: int, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 fps_groups: int = 1):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.fps_groups = fps_groups
        for s, mlp in enumerate(mlps):
            self.add_module(f"mlp{s}", SharedMLP(3 + c_in, mlp))

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xyz [B, N, 3], features [B, N, C] | None -> (new_xyz
        [B, npoint, 3], new_features [B, npoint, sum of last widths])."""
        g = self.fps_groups
        N = xyz.shape[1]
        if g > 1 and self.npoint == N:
            # npoint == N selects every point; grouped mode allows any
            # order, so the original order is kept without sampling
            new_xyz = xyz
        elif g > 1 and N % g == 0 and self.npoint % g == 0:
            new_xyz = gather_points(xyz, hierarchical_fps(xyz, self.npoint, g))
        else:
            new_xyz = gather_points(xyz, furthest_point_sample(xyz, self.npoint))
        c_data = 3 + (0 if features is None else features.shape[-1])
        # route by width alone: a CUDA cloud that is not float32 reaches K1's
        # wrapper and raises there rather than grouping off the kernel
        fused = c_data <= MAX_C
        # opt-in: the whole scale in one kernel (K6), read at call time
        fused_sa = fused and bool(os.environ.get("INTERDIFF_FUSED_SA"))
        # one distance matrix shared by every radius scale; K1 streams the
        # transposed [B, N, M] layout
        d2 = (pairwise_sqdist_t(xyz, new_xyz) if fused
              else pairwise_sqdist(new_xyz, xyz))
        outs = []
        for s, (radius, nsample) in enumerate(zip(self.radii, self.nsamples)):
            if fused_sa:
                outs.append(fused_sa_scale(
                    xyz, new_xyz, features,
                    folded_affine(getattr(self, f"mlp{s}")), radius, nsample,
                    d2))
                continue
            if fused:
                grouped = fused_query_group(xyz, new_xyz, features, radius,
                                            nsample, d2)
            else:
                grouped = query_and_group(xyz, new_xyz, features, radius,
                                          nsample, d2=d2)
            h = getattr(self, f"mlp{s}")(grouped)  # [B, M, S, c_out]
            outs.append(h.amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class PointNet2Encoder(nn.Module):
    """Two-stage MSG set abstraction -> per-keypoint feature
    (`interdiff/model/layers.py:111-175`; ``c_in`` excludes xyz).

    [B, I, P, 3 + c_in] -> [B, I, num_keypoints, c_out], the last axis
    being [xyz (3) | Linear(features) (c_out - 3)].
    """

    def __init__(self, c_in: int = 1, c_out: int = 256,
                 num_keypoints: int = 1, fps_groups: int = 16):
        super().__init__()
        self.num_keypoints = num_keypoints
        self.c_out = c_out
        self.sa0 = SAModuleMSG(c_in, npoint=1024, radii=(0.05, 0.1),
                               nsamples=(16, 32),
                               mlps=((16, 16, 32), (32, 32, 64)),
                               fps_groups=fps_groups)
        self.sa1 = SAModuleMSG(32 + 64, npoint=num_keypoints,
                               radii=(0.1, 0.2), nsamples=(16, 32),
                               mlps=((64, 64, 128), (64, 96, 128)))
        self.Linear = nn.Linear(128 + 128, c_out - 3)

    def forward(self, pointcloud: torch.Tensor) -> torch.Tensor:
        B, I, P, C = pointcloud.shape
        pc = pointcloud.reshape(B * I, P, C)
        xyz = pc[..., :3]
        features = pc[..., 3:] if C > 3 else None
        xyz, features = self.sa0(xyz, features)
        xyz, features = self.sa1(xyz, features)
        out = torch.cat([xyz, self.Linear(features)], dim=-1)
        return out.reshape(B, I, self.num_keypoints, self.c_out)
