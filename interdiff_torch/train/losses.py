"""SMPL-track diffusion losses (`interdiff_tpu/train/losses.py`): the
weighted MSE pyramids of `interdiff/train_diffusion_smpl.py:60-166` (16
terms, per sample), its validation loss and its diverse-sample test loss.

The reference's "velocity" terms subtract the gt sequence from itself, a
zero target, and also penalise the prediction's discrete acceleration
(`train_diffusion_smpl.py:91-99,107-115`).  That is reproduced as it is (the
terms act as smoothness regularisers); ``faithful=False`` switches to the
presumably intended gt-velocity matching for ablation.  The skeleton track's
loss is not ported yet.

All tensors are batch-first: pred/gt [B, T, C].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from interdiff_torch.geometry.rotations import axis_angle_to_matrix


def _l2_per_sample(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MSE over (time, feature) -> [B] (`train_diffusion_smpl.py:54-58`)."""
    return ((a - b) ** 2).mean(dim=(1, 2))

@dataclass(frozen=True)
class SmplLossWeights:
    """Defaults from `train_diffusion_smpl.py:566-573`."""

    smplx_rot: float = 1.0
    smplx_nonrot: float = 0.2
    obj_rot: float = 0.1
    obj_nonrot: float = 0.2
    past: float = 1.0
    v: float = 0.2


def smpl_diffusion_losses(
    pred: torch.Tensor, gt: torch.Tensor, *, past_len: int, smpl_dim: int = 132,
    weights: SmplLossWeights = SmplLossWeights(), faithful: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """16-term weighted loss -> (per-sample loss [B], weighted term dict)."""
    w = weights
    body = pred[..., : smpl_dim + 3]
    body_gt = gt[..., : smpl_dim + 3]
    obj = pred[..., smpl_dim + 3 :]
    obj_gt = gt[..., smpl_dim + 3 :]
    p = past_len

    def split(x):
        return x[..., :-3], x[..., -3:]

    br, bt = split(body)
    br_g, bt_g = split(body_gt)
    orr, ot = split(obj)
    or_g, ot_g = split(obj_gt)

    def vel_past(x, x_gt):
        if faithful:
            tgt = torch.zeros_like(x_gt[:, 1 : p + 1])
        else:
            tgt = x_gt[:, 1 : p + 1] - x_gt[:, :p]
        return (_l2_per_sample(x[:, 1 : p + 1] - x[:, :p], tgt)
                + _l2_per_sample(x[:, 1:p] - x[:, : p - 1],
                                 x[:, 2 : p + 1] - x[:, 1:p]))

    def vel_future(x, x_gt):
        if faithful:
            tgt = torch.zeros_like(x_gt[:, p:])
        else:
            tgt = x_gt[:, p:] - x_gt[:, p - 1 : -1]
        return (_l2_per_sample(x[:, p:] - x[:, p - 1 : -1], tgt)
                + _l2_per_sample(x[:, p - 1 : -2] - x[:, p : -1],
                                 x[:, p : -1] - x[:, p + 1 :]))

    terms = {
        "body_rot_past": _l2_per_sample(br[:, :p], br_g[:, :p])
        * w.smplx_rot * w.past,
        "body_nonrot_past": _l2_per_sample(bt[:, :p], bt_g[:, :p])
        * w.smplx_nonrot * w.past,
        "obj_rot_past": _l2_per_sample(orr[:, :p], or_g[:, :p])
        * w.obj_rot * w.past,
        "obj_nonrot_past": _l2_per_sample(ot[:, :p], ot_g[:, :p])
        * w.obj_nonrot * w.past,
        "body_rot_v_past": vel_past(br, br_g) * w.v * w.smplx_rot * w.past,
        "body_nonrot_v_past": vel_past(bt, bt_g) * w.v * w.smplx_nonrot * w.past,
        "obj_rot_v_past": vel_past(orr, or_g) * w.v * w.obj_rot * w.past,
        "obj_nonrot_v_past": vel_past(ot, ot_g) * w.v * w.obj_nonrot * w.past,
        "body_rot_future": _l2_per_sample(br[:, p:], br_g[:, p:]) * w.smplx_rot,
        "body_nonrot_future": _l2_per_sample(bt[:, p:], bt_g[:, p:])
        * w.smplx_nonrot,
        "obj_rot_future": _l2_per_sample(orr[:, p:], or_g[:, p:]) * w.obj_rot,
        "obj_nonrot_future": _l2_per_sample(ot[:, p:], ot_g[:, p:])
        * w.obj_nonrot,
        "body_rot_v_future": vel_future(br, br_g) * w.v * w.smplx_rot,
        "body_nonrot_v_future": vel_future(bt, bt_g) * w.v * w.smplx_nonrot,
        "obj_rot_v_future": vel_future(orr, or_g) * w.v * w.obj_rot,
        "obj_nonrot_v_future": vel_future(ot, ot_g) * w.v * w.obj_nonrot,
    }
    loss = sum(terms.values())  # [B]
    return loss, terms


def smpl_val_losses(
    body_pred: torch.Tensor, body_gt: torch.Tensor, obj_pred: torch.Tensor,
    obj_gt: torch.Tensor, *, past_len: int,
    weights: SmplLossWeights = SmplLossWeights(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Validation loss in rotation-MATRIX space (`calc_val_loss`,
    `train_diffusion_smpl.py:185-260`): 16 scalar MSE terms over sampled
    axis-angle predictions; velocity terms here use real gt deltas.

    body_pred/gt [B, T, 3*nJ + 3] (axis-angle | trans), obj_pred/gt [B, T, 6].
    """
    w = weights
    p = past_len
    B, T = body_pred.shape[:2]

    def rots(x, n):
        return axis_angle_to_matrix(
            x[..., : 3 * n].reshape(B, T, n, 3)).reshape(B, T, n * 9)

    nJ = (body_pred.shape[-1] - 3) // 3
    br, br_g = rots(body_pred, nJ), rots(body_gt, nJ)
    orr, or_g = rots(obj_pred, 1), rots(obj_gt, 1)
    bt, bt_g = body_pred[..., -3:], body_gt[..., -3:]
    ot, ot_g = obj_pred[..., -3:], obj_gt[..., -3:]

    def mse(a, b):
        return ((a - b) ** 2).mean()

    def vp(x, x_g):  # past velocity
        return mse(x[:, 1 : p + 1] - x[:, :p], x_g[:, 1 : p + 1] - x_g[:, :p])

    def vf(x, x_g):  # future velocity
        return mse(x[:, p:] - x[:, p - 1 : -1], x_g[:, p:] - x_g[:, p - 1 : -1])

    terms = {
        "body_rot_past": mse(br[:, :p], br_g[:, :p]) * w.smplx_rot * w.past,
        "body_nonrot_past": mse(bt[:, :p], bt_g[:, :p])
        * w.smplx_nonrot * w.past,
        "obj_rot_past": mse(orr[:, :p], or_g[:, :p]) * w.obj_rot * w.past,
        "obj_nonrot_past": mse(ot[:, :p], ot_g[:, :p]) * w.obj_nonrot * w.past,
        "body_rot_v_past": vp(br, br_g) * w.v * w.smplx_rot * w.past,
        "body_nonrot_v_past": vp(bt, bt_g) * w.v * w.smplx_nonrot * w.past,
        "obj_rot_v_past": vp(orr, or_g) * w.v * w.obj_rot * w.past,
        "obj_nonrot_v_past": vp(ot, ot_g) * w.v * w.obj_nonrot * w.past,
        "body_rot_future": mse(br[:, p:], br_g[:, p:]) * w.smplx_rot,
        "body_nonrot_future": mse(bt[:, p:], bt_g[:, p:]) * w.smplx_nonrot,
        "obj_rot_future": mse(orr[:, p:], or_g[:, p:]) * w.obj_rot,
        "obj_nonrot_future": mse(ot[:, p:], ot_g[:, p:]) * w.obj_nonrot,
        "body_rot_v_future": vf(br, br_g) * w.v * w.smplx_rot,
        "body_nonrot_v_future": vf(bt, bt_g) * w.v * w.smplx_nonrot,
        "obj_rot_v_future": vf(orr, or_g) * w.v * w.obj_rot,
        "obj_nonrot_v_future": vf(ot, ot_g) * w.v * w.obj_nonrot,
    }
    return sum(terms.values()), terms


def smpl_diverse_test_losses(
    body_pred: torch.Tensor,  # [N, B, T, 3*nJ + 3] diverse sampled aa + trans
    body_gt: torch.Tensor,  # [B, T, 3*nJ + 3]
    obj_pred: torch.Tensor,  # [N, B, T, 6]
    obj_gt: torch.Tensor,  # [B, T, 6]
    *, past_len: int,
    weights: SmplLossWeights = SmplLossWeights(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Diverse-sample test loss (`calc_loss`,
    `train_diffusion_smpl.py:262-379`): the 16 rotation-matrix-space terms
    averaged over ALL diverse samples plus their 16 ``*_min`` variants
    (per-clip min over the sample axis, then batch mean — the best-of-N
    lens the test loop logs).  Returns ``(weighted sum, loss_dict,
    weighted_loss_dict)`` like the reference; only the 16 mean terms are
    weighted/summed, the ``_min`` terms are diagnostics.

    Slice quirk reproduced: the FUTURE velocity here differs from
    `calc_val_loss` — deltas `[p+1:] - [p:-1]` on both sides (`:293-298`),
    not the val loss's `[p:] - [p-1:-1]`.
    """
    w = weights
    p = past_len
    N, B, T = body_pred.shape[:3]
    nJ = (body_pred.shape[-1] - 3) // 3

    def rots(x, n):
        return axis_angle_to_matrix(
            x[..., : 3 * n].reshape(x.shape[:-1] + (n, 3))
        ).reshape(x.shape[:-1] + (n * 9,))

    br = rots(body_pred, nJ)
    br_g = rots(body_gt, nJ)[None].expand(br.shape)
    orr = rots(obj_pred, 1)
    or_g = rots(obj_gt, 1)[None].expand(orr.shape)
    bt, ot = body_pred[..., -3:], obj_pred[..., -3:]
    bt_g = body_gt[None, ..., -3:].expand(bt.shape)
    ot_g = obj_gt[None, ..., -3:].expand(ot.shape)

    def mean_term(a, b):
        return ((a - b) ** 2).mean()

    def min_term(a, b):
        # per (sample, clip) mean over (T, C), min over samples, batch mean
        per = ((a - b) ** 2).mean(dim=(2, 3))  # [N, B]
        return per.amin(dim=0).mean()

    def d_past(x):
        return x[:, :, 1 : p + 1] - x[:, :, :p]

    def d_fut(x):
        return x[:, :, p + 1 :] - x[:, :, p:-1]

    pairs = {
        "body_rot_past": (br[:, :, :p], br_g[:, :, :p]),
        "body_nonrot_past": (bt[:, :, :p], bt_g[:, :, :p]),
        "obj_rot_past": (orr[:, :, :p], or_g[:, :, :p]),
        "obj_nonrot_past": (ot[:, :, :p], ot_g[:, :, :p]),
        "body_rot_v_past": (d_past(br), d_past(br_g)),
        "body_nonrot_v_past": (d_past(bt), d_past(bt_g)),
        "obj_rot_v_past": (d_past(orr), d_past(or_g)),
        "obj_nonrot_v_past": (d_past(ot), d_past(ot_g)),
        "body_rot_future": (br[:, :, p:], br_g[:, :, p:]),
        "body_nonrot_future": (bt[:, :, p:], bt_g[:, :, p:]),
        "obj_rot_future": (orr[:, :, p:], or_g[:, :, p:]),
        "obj_nonrot_future": (ot[:, :, p:], ot_g[:, :, p:]),
        "body_rot_v_future": (d_fut(br), d_fut(br_g)),
        "body_nonrot_v_future": (d_fut(bt), d_fut(bt_g)),
        "obj_rot_v_future": (d_fut(orr), d_fut(or_g)),
        "obj_nonrot_v_future": (d_fut(ot), d_fut(ot_g)),
    }
    loss_dict = {k: mean_term(a, b) for k, (a, b) in pairs.items()}
    loss_dict.update({f"{k}_min": min_term(a, b)
                      for k, (a, b) in pairs.items()})

    wmap = {
        "body_rot": w.smplx_rot, "body_nonrot": w.smplx_nonrot,
        "obj_rot": w.obj_rot, "obj_nonrot": w.obj_nonrot,
    }

    def weight_of(name: str) -> float:
        base = wmap[name.rsplit("_", 2)[0] if "_v_" in name
                    else name.rsplit("_", 1)[0]]
        if "_v_" in name:
            base *= w.v
        if name.endswith("_past"):
            base *= w.past
        return base

    weighted = {k: loss_dict[k] * weight_of(k) for k in pairs}
    return sum(weighted.values()), loss_dict, weighted
