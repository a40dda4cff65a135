"""Correction-network training losses
(`interdiff_tpu/train/losses_correction.py`), contracts of
`interdiff/train_correction_smpl.py:59-185` (8 pose-MSE terms plus contact
and penetration with epoch annealing) and
`train_correction_skeleton.py:84-126` (the same 8 pose terms in quaternion
space).

Batch-first: obj_pred / obj_gt [B, T, C].  The contact and penetration
terms reach the nearest-neighbour kernels with their gradients: the
object->body half is K3 (`ops/signed_distance.py::signed_nearest`), the
body->object half K4 (`nearest_neighbor`), both differentiable with
respect to the object points, which carry the gradient to the predicted
pose.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from interdiff_torch.geometry.rotations import rotation_6d_to_matrix
from interdiff_torch.ops.signed_distance import (
    nearest_neighbor,
    safe_sqrt,
    signed_nearest,
)


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


@dataclass(frozen=True)
class CorrectionLossWeights:
    """Defaults = `train_correction_smpl.py:306-319` argparse (identical to
    the shipped correction.ckpt hparams)."""

    obj_rot: float = 0.1
    obj_nonrot: float = 0.1
    past: float = 0.5
    v: float = 1.0
    contact: float = 1.0
    penetration: float = 0.1
    use_annealing: bool = True
    second_stage: int = 20


def pose_terms(obj_pred: torch.Tensor, obj_gt: torch.Tensor, *,
               past_len: int, w: CorrectionLossWeights
               ) -> Dict[str, torch.Tensor]:
    """The 8 shared pose-MSE terms (velocities use real gt deltas)."""
    p = past_len
    rot, rot_g = obj_pred[..., :-3], obj_gt[..., :-3]
    tr, tr_g = obj_pred[..., -3:], obj_gt[..., -3:]

    def d(x):
        return x[:, 1 : p + 1] - x[:, :p]

    def df(x):
        return x[:, p:] - x[:, p - 1 : -1]

    past = w.past
    return {
        "obj_rot_past": _mse(rot[:, :p], rot_g[:, :p]) * w.obj_rot * past,
        "obj_nonrot_past": _mse(tr[:, :p], tr_g[:, :p]) * w.obj_nonrot
        * past,
        "obj_rot_v_past": _mse(d(rot), d(rot_g)) * w.v * w.obj_rot * past,
        "obj_nonrot_v_past": _mse(d(tr), d(tr_g)) * w.v * w.obj_nonrot
        * past,
        "obj_rot_future": _mse(rot[:, p:], rot_g[:, p:]) * w.obj_rot,
        "obj_nonrot_future": _mse(tr[:, p:], tr_g[:, p:]) * w.obj_nonrot,
        "obj_rot_v_future": _mse(df(rot), df(rot_g)) * w.v * w.obj_rot,
        "obj_nonrot_v_future": _mse(df(tr), df(tr_g)) * w.v * w.obj_nonrot,
    }


def contact_penetration_terms(
    obj_pred: torch.Tensor,  # [B, T, 9] rot6d + trans
    obj_points: torch.Tensor,  # [B, P, >=3] canonical template
    human_verts: torch.Tensor,  # [B, T, V, 7] xyz | normals | contact label
    *, nn_chunk: Optional[int] = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss_contact, loss_penetration) (`train_correction_smpl.py:103-156`).

    contact: mean |h2o| over labelled-contact vertices farther than 0.02 m;
    penetration: mean |o2h| weighted 20 on object points inside the body.
    ``nn_chunk`` is accepted for the JAX signature and has no effect.
    """
    B, T = obj_pred.shape[:2]
    rot = rotation_6d_to_matrix(obj_pred[..., :6])  # [B,T,3,3]
    pts = (torch.einsum("btij,bpj->btpi", rot, obj_points[..., :3])
           + obj_pred[..., None, 6:9])

    # the reference's bidirectional `point2point_signed` call
    # (`train_correction_smpl.py:131`) split into the two halves it uses:
    # object->body needs the distance and the pseudonormal sign (K3), and
    # body->object only |h2o| (K4)
    hv = human_verts.reshape(B * T, -1, 7)
    pts_flat = pts.reshape(B * T, -1, 3)
    o2h_sq, o2h_dot = signed_nearest(pts_flat, hv[..., :3], hv[..., 3:6])
    # safe_sqrt: sq is exactly 0 for touching geometry, where the gradient
    # of sqrt would turn the step into NaN
    o2h_signed = safe_sqrt(o2h_sq) * torch.sign(o2h_dot)
    h2o_sq, _ = nearest_neighbor(hv[..., :3], pts_flat)
    h2o = safe_sqrt(h2o_sq)

    contact_label = hv[..., 6]
    v_contact = ((h2o > 0.02) & (contact_label > 0.5)).to(torch.float32)
    loss_contact = (h2o * v_contact).mean()

    w_pen = torch.where(o2h_signed < 0, 20.0, 0.0)
    loss_penetration = (o2h_signed.abs() * w_pen).mean()
    return loss_contact, loss_penetration


def annealing(epoch: float, weights: CorrectionLossWeights) -> np.float32:
    """The contact and penetration terms' factor: clip(epoch /
    second_stage, 0, 1) squared, in float32 as the JAX package computes it
    (1 without annealing)."""
    if not weights.use_annealing:
        return np.float32(1.0)
    a = np.clip(np.float32(epoch) / np.float32(weights.second_stage),
                np.float32(0.0), np.float32(1.0))
    return np.float32(a * a)


def correction_smpl_losses(
    obj_pred: torch.Tensor, obj_gt: torch.Tensor, *, past_len: int,
    obj_points: torch.Tensor, human_verts: torch.Tensor, epoch: float,
    weights: CorrectionLossWeights = CorrectionLossWeights(),
    nn_chunk: Optional[int] = 512,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full SMPL correction loss (`calc_loss_contact`, `:103-185`)."""
    w = weights
    terms = pose_terms(obj_pred, obj_gt, past_len=past_len, w=w)
    loss_contact, loss_pen = contact_penetration_terms(
        obj_pred, obj_points, human_verts, nn_chunk=nn_chunk)
    anneal2 = float(annealing(epoch, w))
    terms["contact"] = anneal2 * loss_contact * w.contact
    terms["penetration"] = anneal2 * loss_pen * w.penetration
    return sum(terms.values()), terms


def correction_skeleton_losses(
    obj_pred: torch.Tensor, obj_gt: torch.Tensor, *, past_len: int,
    weights: CorrectionLossWeights = CorrectionLossWeights(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Skeleton correction loss: 8 quaternion-space pose terms
    (`train_correction_skeleton.py:84-126`); obj layout [quat(4) | trans(3)]
    split by ``[..., :-3]`` / ``[..., -3:]`` as in the reference."""
    terms = pose_terms(obj_pred, obj_gt, past_len=past_len, w=weights)
    return sum(terms.values()), terms
