"""Interaction-correction networks (`ObjProjector`,
`interdiff_tpu/models/correction.py`) of both tracks, contracts of
`interdiff/model/correction_smpl.py` (67 SSM markers, contact-based marker
selection) and `interdiff/model/correction_skeleton.py` (21 joints, the
absolute-stream node, quaternion I/O).

The object trajectory is lifted to a contact-relative representation
(object rot6d plus the translation relative to every human marker), DCT'd
over time keeping ``n_pre`` coefficients, run through three ST-GCNN stacks
(relative markers / absolute single node / fused markers + 1) with residual
connections, then inverse-DCT'd back; the future object frames are padded
with the last past frame before the DCT, so the network inpaints the future
in frequency space.  Tensors are batch-first channels-last [B, T, V, C]; the
marker choice is a masked `where` / `gather`, never boolean indexing, so
shapes do not depend on the data.

``train=True`` runs the ST-GCNN layers in train mode (batch statistics,
the running ones moved by momentum; dropout from ``generator``) and, on the
SMPL track, draws the marker multinomially instead of taking the first
maximum.  Under a data mesh the statistics are the global batch's, the
marker draw is made for the global batch and dropout draws from the rank's
own stream (`parallel/mesh.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from interdiff_torch import resolve_device
from interdiff_torch.data.constants import hand_bias_vector
from interdiff_torch.geometry.dct import dct_matrices
from interdiff_torch.geometry.rotations import (
    matrix_to_quaternion,
    matrix_to_rotation_6d,
    quat_wxyz_to_xyzw,
    quat_xyzw_to_wxyz,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)
from interdiff_torch.models.layers import STGCNNLayer
from interdiff_torch.parallel.mesh import draw_rows


def pad_future_with_last_past(x: torch.Tensor, past_len: int) -> torch.Tensor:
    """``x[idx_pad]`` (`correction_smpl.py:84-87`): keep the past frames and
    repeat the last past frame over the future, along axis 1 (time)."""
    T = x.shape[1]
    idx = np.concatenate([np.arange(past_len),
                          np.full(T - past_len, past_len - 1)])
    return x[:, idx]


class _STStack(nn.Module):
    """Four ST-GCNN layers ``gcn0 .. gcn3`` with the reference's channel
    schedule, e.g. (9, 32, 16, 32, 9)."""

    def __init__(self, channels: Tuple[int, ...], time_dim: int,
                 joints_dim: int, version: int, dropout: float = 0.0):
        super().__init__()
        self.depth = len(channels) - 1
        for i in range(self.depth):
            self.add_module(f"gcn{i}", STGCNNLayer(
                channels[i], channels[i + 1], time_dim, joints_dim,
                version=version, dropout=dropout))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"gcn{i}")(x, train, generator)
        return x


class ObjProjectorCore(nn.Module):
    """Shared projector trunk -> per-node corrected trajectories.

    obj9 [B, T, 9] (rot6d | trans), markers [B, T, P, 3] -> [B, T, P+1, 9]:
    node 0 is the absolute stream, nodes 1..P the marker-relative streams
    (`correction_smpl.py:79-121`).
    """

    def __init__(self, num_nodes: int, n_pre: int, seq_len: int,
                 past_len: int,
                 fusion_channels: Tuple[int, ...] = (9, 32, 16, 32, 9),
                 dropout: float = 0.0):
        super().__init__()
        self.past_len = past_len
        dct, idct = dct_matrices(seq_len)
        self.register_buffer("dct", torch.from_numpy(dct[:n_pre].copy()),
                             persistent=False)  # [K, T]
        self.register_buffer("idct", torch.from_numpy(idct[:, :n_pre].copy()),
                             persistent=False)  # [T, K]
        self.st_gcnns_relative = _STStack((9, 32, 16, 32, 9), n_pre,
                                          num_nodes, 0, dropout)
        self.st_gcnns = _STStack((9, 32, 16, 32, 9), n_pre, 1, 0, dropout)
        self.st_gcnns_all = _STStack(fusion_channels, n_pre, num_nodes + 1,
                                     2, dropout)

    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("kt,bt...->bk...", self.dct, x)

    def forward(self, obj9: torch.Tensor, markers: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # relative stream over P marker nodes
        rel_trans = obj9[:, :, None, 6:9] - markers  # [B,T,P,3]
        rot_rep = obj9[:, :, None, :6].expand(rel_trans.shape[:3] + (6,))
        rel = torch.cat([rot_rep, rel_trans], dim=-1)  # [B,T,P,9]
        rel = self._fwd(pad_future_with_last_past(rel, self.past_len))
        rel = rel + self.st_gcnns_relative(rel, train, generator)

        # relative -> absolute translation, in DCT space (linear, commutes);
        # the human markers are not future-padded (`:101-103`)
        human_dct = self._fwd(markers)  # [B,K,P,3]
        multi = torch.cat([rel[..., :6], rel[..., 6:9] + human_dct], dim=-1)

        # absolute single-node stream
        absn = self._fwd(
            pad_future_with_last_past(obj9, self.past_len))[:, :, None]
        absn = absn + self.st_gcnns(absn, train, generator)

        # fusion over P+1 nodes (spatio-temporal graph conv, version 2)
        fused = torch.cat([absn, multi], dim=2)  # [B,K,P+1,9]
        fused = fused + self.st_gcnns_all(fused, train, generator)
        return torch.einsum("tk,bk...->bt...", self.idct, fused)


class ObjProjectorSmpl(nn.Module):
    """SMPL-track correction net (`correction_smpl.py:8-137`), built on
    ``device`` (CUDA unless given).

    ``sample(obj9, markers, contact)``: obj9 [B,T,9], markers [B,T,P,3]
    (xyz only), contact [B,P] the per-marker contact counts over the future
    frames (`:76`).  Marker choice: the mean over nodes when ``initialize``
    (early training epochs); otherwise the absolute node for samples
    without contact and, for the rest, a marker by the weights ``contact +
    0.5 hand bias``: their first maximum in eval mode, a multinomial draw
    from ``generator`` in train mode (the JAX package draws
    ``jax.random.categorical`` over their logarithms; a test passes that
    draw as ``marker_idx``).
    """

    def __init__(self, num_markers: int = 67, n_pre: int = 10,
                 past_len: int = 10, future_len: int = 25,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.past_len = past_len
        self.core = ObjProjectorCore(
            num_nodes=num_markers, n_pre=n_pre,
            seq_len=past_len + future_len, past_len=past_len,
            fusion_channels=(9, 32, 16, 32, 9), dropout=dropout)
        self.register_buffer(
            "hand_bias", torch.from_numpy(hand_bias_vector(num_markers)),
            persistent=False)
        self.to(resolve_device(device))

    def forward(self, obj9, markers, contact, *, initialize: bool = False,
                train: bool = False, generator=None, marker_idx=None):
        return self.sample(obj9, markers, contact, initialize=initialize,
                           train=train, generator=generator,
                           marker_idx=marker_idx)

    def sample(self, obj9: torch.Tensor, markers: torch.Tensor,
               contact: torch.Tensor, *, initialize: bool = False,
               train: bool = False,
               generator: Optional[torch.Generator] = None,
               marker_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> corrected [B, T, 9].  ``marker_idx`` [B] overrides the
        marker choice (train or eval mode)."""
        results = self.core(obj9, markers, train, generator)  # [B,T,P+1,9]
        if initialize:
            return results.mean(dim=2)

        has_contact = contact.sum(dim=-1) > 0  # [B]
        weights = contact.to(torch.float32) + self.hand_bias  # [B,P]
        if marker_idx is not None:
            idx = marker_idx.to(torch.int64)
        elif train:
            # contact counts are never negative in real data; a random
            # batch's are clamped, where the JAX package's log turns them
            # into NaN logits.  The categorical draw is torch.multinomial's
            # own for one sample, argmax(w / q) with q ~ Exp(1), its q drawn
            # for the global batch under a data mesh (`draw_rows`)
            q = draw_rows(lambda n: torch.empty(
                (n,) + tuple(weights.shape[1:]), device=weights.device
            ).exponential_(1.0, generator=generator), weights.shape[0])
            idx = torch.argmax(weights.clamp(min=0.0) / q, dim=-1)
        else:
            idx = torch.argmax(weights, dim=-1)  # first maximum on ties
        B, T = results.shape[:2]
        pick = (idx + 1)[:, None, None, None].expand(B, T, 1, 9)
        marker_pick = results.gather(2, pick)[:, :, 0]  # [B,T,9]
        return torch.where(has_contact[:, None, None], marker_pick,
                           results[:, :, 0])


class ObjProjectorSkeleton(nn.Module):
    """Skeleton-track correction net (`correction_skeleton.py:7-134`), built
    on ``device`` (CUDA unless given).

    I/O in the dataset's 7-D pose convention, quaternion **xyzw**; inside,
    the object is rot6d | trans.  The output is always the absolute-stream
    node (`:130` takes node 0); this track has no contact-based choice.
    """

    def __init__(self, num_joints: int = 21, n_pre: int = 20,
                 past_len: int = 10, future_len: int = 10,
                 dropout: float = 0.0, device=None):
        super().__init__()
        self.past_len = past_len
        seq_len = past_len + future_len
        self.core = ObjProjectorCore(
            num_nodes=num_joints,
            n_pre=min(n_pre, seq_len),  # no more DCT coefficients than frames
            seq_len=seq_len, past_len=past_len,
            fusion_channels=(9, 64, 32, 64, 9), dropout=dropout)
        self.to(resolve_device(device))

    def forward(self, obj_quat_xyzw, obj_trans, joints, *,
                train: bool = False, generator=None):
        return self.sample(obj_quat_xyzw, obj_trans, joints, train=train,
                           generator=generator)

    def sample(self, obj_quat_xyzw: torch.Tensor, obj_trans: torch.Tensor,
               joints: torch.Tensor, *, train: bool = False,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """quat [B,T,4] xyzw, trans [B,T,3], joints [B,T,J,3] ->
        (corrected quat xyzw [B,T,4], corrected trans [B,T,3])."""
        rot6d = matrix_to_rotation_6d(
            quaternion_to_matrix(quat_xyzw_to_wxyz(obj_quat_xyzw)))
        obj9 = torch.cat([rot6d, obj_trans], dim=-1)
        results = self.core(obj9, joints, train, generator)[:, :, 0]
        quat = matrix_to_quaternion(rotation_6d_to_matrix(results[..., :6]))
        return quat_wxyz_to_xyzw(quat), results[..., 6:9]
