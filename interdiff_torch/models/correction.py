"""Interaction-correction network of the SMPL track (`ObjProjector`,
`interdiff_tpu/models/correction.py`), contract of
`interdiff/model/correction_smpl.py` (67 SSM markers, contact-based marker
selection).

The object trajectory is lifted to a contact-relative representation
(object rot6d plus the translation relative to every human marker), DCT'd
over time keeping ``n_pre`` coefficients, run through three ST-GCNN stacks
(relative markers / absolute single node / fused markers + 1) with residual
connections, then inverse-DCT'd back; the future object frames are padded
with the last past frame before the DCT, so the network inpaints the future
in frequency space.  Tensors are batch-first channels-last [B, T, V, C]; the
marker choice is a masked `where` / `gather`, never boolean indexing, so
shapes do not depend on the data.

Inference mode only: the multinomial marker choice of training and the
skeleton-track projector are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from interdiff_torch import resolve_device
from interdiff_torch.data.constants import hand_bias_vector
from interdiff_torch.geometry.dct import dct_matrices
from interdiff_torch.models.layers import STGCNNLayer


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
                 joints_dim: int, version: int):
        super().__init__()
        self.depth = len(channels) - 1
        for i in range(self.depth):
            self.add_module(f"gcn{i}", STGCNNLayer(
                channels[i], channels[i + 1], time_dim, joints_dim,
                version=version))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"gcn{i}")(x)
        return x


class ObjProjectorCore(nn.Module):
    """Shared projector trunk -> per-node corrected trajectories.

    obj9 [B, T, 9] (rot6d | trans), markers [B, T, P, 3] -> [B, T, P+1, 9]:
    node 0 is the absolute stream, nodes 1..P the marker-relative streams
    (`correction_smpl.py:79-121`).
    """

    def __init__(self, num_nodes: int, n_pre: int, seq_len: int,
                 past_len: int,
                 fusion_channels: Tuple[int, ...] = (9, 32, 16, 32, 9)):
        super().__init__()
        self.past_len = past_len
        dct, idct = dct_matrices(seq_len)
        self.register_buffer("dct", torch.from_numpy(dct[:n_pre].copy()),
                             persistent=False)  # [K, T]
        self.register_buffer("idct", torch.from_numpy(idct[:, :n_pre].copy()),
                             persistent=False)  # [T, K]
        self.st_gcnns_relative = _STStack((9, 32, 16, 32, 9), n_pre,
                                          num_nodes, version=0)
        self.st_gcnns = _STStack((9, 32, 16, 32, 9), n_pre, 1, version=0)
        self.st_gcnns_all = _STStack(fusion_channels, n_pre, num_nodes + 1,
                                     version=2)

    def _fwd(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("kt,bt...->bk...", self.dct, x)

    def forward(self, obj9: torch.Tensor, markers: torch.Tensor
                ) -> torch.Tensor:
        # relative stream over P marker nodes
        rel_trans = obj9[:, :, None, 6:9] - markers  # [B,T,P,3]
        rot_rep = obj9[:, :, None, :6].expand(rel_trans.shape[:3] + (6,))
        rel = torch.cat([rot_rep, rel_trans], dim=-1)  # [B,T,P,9]
        rel = self._fwd(pad_future_with_last_past(rel, self.past_len))
        rel = rel + self.st_gcnns_relative(rel)  # [B,K,P,9]

        # relative -> absolute translation, in DCT space (linear, commutes);
        # the human markers are not future-padded (`:101-103`)
        human_dct = self._fwd(markers)  # [B,K,P,3]
        multi = torch.cat([rel[..., :6], rel[..., 6:9] + human_dct], dim=-1)

        # absolute single-node stream
        absn = self._fwd(
            pad_future_with_last_past(obj9, self.past_len))[:, :, None]
        absn = absn + self.st_gcnns(absn)

        # fusion over P+1 nodes (spatio-temporal graph conv, version 2)
        fused = torch.cat([absn, multi], dim=2)  # [B,K,P+1,9]
        fused = fused + self.st_gcnns_all(fused)
        return torch.einsum("tk,bk...->bt...", self.idct, fused)


class ObjProjectorSmpl(nn.Module):
    """SMPL-track correction net (`correction_smpl.py:8-137`), built on
    ``device`` (CUDA unless given).

    ``sample(obj9, markers, contact)``: obj9 [B,T,9], markers [B,T,P,3]
    (xyz only), contact [B,P] the per-marker contact counts over the future
    frames (`:76`).  Marker choice: the mean over nodes when ``initialize``
    (early training epochs); otherwise the absolute node for samples
    without contact and, for the rest, the first maximum of the contact
    counts plus the 0.5 hand bias.
    """

    def __init__(self, num_markers: int = 67, n_pre: int = 10,
                 past_len: int = 10, future_len: int = 25, device=None):
        super().__init__()
        self.core = ObjProjectorCore(
            num_nodes=num_markers, n_pre=n_pre,
            seq_len=past_len + future_len, past_len=past_len,
            fusion_channels=(9, 32, 16, 32, 9))
        self.register_buffer(
            "hand_bias", torch.from_numpy(hand_bias_vector(num_markers)),
            persistent=False)
        self.to(resolve_device(device))

    def forward(self, obj9, markers, contact, *, initialize: bool = False,
                train: bool = False):
        return self.sample(obj9, markers, contact, initialize=initialize,
                           train=train)

    def sample(self, obj9: torch.Tensor, markers: torch.Tensor,
               contact: torch.Tensor, *, initialize: bool = False,
               train: bool = False) -> torch.Tensor:
        """-> corrected [B, T, 9]."""
        if train:
            raise NotImplementedError(
                "the multinomial marker choice of training comes with the "
                "training slice of the port")
        results = self.core(obj9, markers)  # [B,T,P+1,9]
        if initialize:
            return results.mean(dim=2)

        has_contact = contact.sum(dim=-1) > 0  # [B]
        weights = contact.to(torch.float32) + self.hand_bias  # [B,P]
        idx = torch.argmax(weights, dim=-1)  # first maximum on ties
        B, T = results.shape[:2]
        pick = (idx + 1)[:, None, None, None].expand(B, T, 1, 9)
        marker_pick = results.gather(2, pick)[:, :, 0]  # [B,T,9]
        return torch.where(has_contact[:, None, None], marker_pick,
                           results[:, :, 0])
