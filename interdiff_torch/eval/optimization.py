"""Test-time refinement (`interdiff_tpu/eval/optimization.py`), contract of
`interdiff/optimization.py`: 200 Adam (lr 1e-3) iterations over body, hand
and global rotations (as raw rotation matrices, as the reference does),
body and object translations and the object rotation, minimising
penetration + a vertex anchor outside the contact region + a foot-skate
lock + first- and second-order smoothness + anchors to the initial values;
the best iterate after iteration ``keep_after`` is kept.

In PyTorch idiom: the clips are stacked on a leading axis, one Python loop
runs the iterations, `torch.optim.Adam` steps every clip's tensors at once.
The loss of a batch is the sum of the clips' losses, so each clip's
gradient is its own loss's, and Adam, elementwise, descends every clip as
if alone; each clip keeps its own best iterate.  Each iteration runs SMPL
FK, vertex normals, the object->body signed nearest neighbour (kernel K3,
differentiable with respect to the object points, the body surface and its
normals) and the body->object nearest neighbour of the contact mask
(kernel K4, on detached inputs).  Nothing is read back to the host inside
the loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from interdiff_torch import full_f32
from interdiff_torch.geometry.normals import vertex_normals
from interdiff_torch.geometry.rotations import (
    axis_angle_to_matrix,
    matrix_to_axis_angle,
)
from interdiff_torch.ops.signed_distance import (
    nearest_neighbor,
    safe_sqrt,
    signed_nearest,
)
from interdiff_torch.smpl.model import SmplModel, smpl_forward


@dataclass(frozen=True)
class OptimConfig:
    iters: int = 200
    lr: float = 1e-3
    keep_after: int = 150
    ratio_denom: float = 350.0  # penetration annealing (`optimization.py:141`)
    foot_static_thresh: float = 0.008
    # stop the gradient of the body (surface and normals) in the
    # penetration term, so that only the object is pushed out (an ablation
    # of the JAX package, where the body gradient measured better)
    pen_fix_body: bool = False


# columns of the per-iteration diagnostics trace (``terms``)
TERM_NAMES = ("loss_dist_o", "loss_verts_reg", "reg_anchors", "loss_smooth",
              "pen_depth", "pen_frac")
_PARAMS = ("body_rot", "transl", "glo_rot", "obj_transl", "obj_rot",
           "hand_rot")
_XZ = [0, 2]


def _mean_from(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Mean over every dimension from ``dim`` on: [C, ...] -> [C]."""
    return x.flatten(dim).mean(dim=dim)


def _first_second_order(x: torch.Tensor, w2: float, w1: float
                        ) -> torch.Tensor:
    """w2 * ||accel||^2 + w1 * ||vel||^2 smoothness per clip (`:89-107`);
    x [C, T, ...] -> [C]."""
    acc = (x[:, 1:-1] - x[:, :-2]) - (x[:, 2:] - x[:, 1:-1])
    vel = x[:, 1:] - x[:, :-1]
    return w2 * _mean_from(acc ** 2) + w1 * _mean_from(vel ** 2)


def _static_feet(jtr: torch.Tensor, thresh: float):
    """(left, right) [C, T-1] bool: feet (joints 10, 11) that move less
    than ``thresh`` in the ground plane between two frames."""
    out = []
    for j in (10, 11):
        f = jtr[:, :, j][..., _XZ]
        out.append(torch.linalg.norm(f[:, 1:] - f[:, :-1], dim=-1) + 1e-6
                   < thresh)
    return out


def _forward(smpl: SmplModel, p: Dict[str, torch.Tensor],
             betas: torch.Tensor):
    """FK of the parameters: (verts [C,T,V,3], joints [C,T,J,3])."""
    C, T = p["transl"].shape[:2]
    pose = matrix_to_axis_angle(torch.cat(
        [p["glo_rot"], p["body_rot"], p["hand_rot"]], dim=2)
    ).reshape(C * T, -1)
    verts, jtr, _, _ = smpl_forward(smpl, pose, betas.reshape(C * T, -1),
                                    p["transl"].reshape(C * T, 3))
    return verts.reshape(C, T, -1, 3), jtr.reshape(C, T, -1, 3)


def refiner_loss(smpl: SmplModel, cfg: OptimConfig,
                 p: Dict[str, torch.Tensor], ratio: float,
                 aux: Dict[str, torch.Tensor]):
    """The refiner's objective (`interdiff_tpu/eval/optimization.py:123-214`)
    for every clip: (total [C], terms [C, len(TERM_NAMES)]).

    ``p``: the parameters, [C, T, ...] each; ``ratio`` the iteration over
    ``ratio_denom``; ``aux``: ``verts_gt``, the static-foot masks, ``betas``,
    ``obj_points`` [C, P, 3] and the initial values under ``anchor_*``."""
    verts, jtr = _forward(smpl, p, aux["betas"])
    pts = (torch.einsum("cpj,ctij->ctpi", aux["obj_points"], p["obj_rot"])
           + p["obj_transl"][:, :, None])
    normals = vertex_normals(verts, smpl.faces_idx, smpl.incident)
    if cfg.pen_fix_body:
        pen_surf, pen_norm = verts.detach(), normals.detach()
    else:
        pen_surf, pen_norm = verts, normals
    # K3 with its gradient through the queries, the surface and the
    # normals
    o2h_sq, o2h_dot = signed_nearest(pts, pen_surf, pen_norm)
    # safe_sqrt: a penetrating point that crosses the surface has sq == 0
    o2h_signed = safe_sqrt(o2h_sq) * torch.sign(o2h_dot)  # [C, T, P]

    pen_w = np.float32(20.0) * ratio if ratio < 1.0 else np.float32(20.0)
    inside = o2h_signed < 0
    w = torch.where(inside, float(pen_w), 0.0)
    loss_dist_o = (o2h_signed.abs() * w).sum(dim=2).mean(dim=1)
    # unweighted diagnostics over the whole window: the mean depth of the
    # inside points and the share of points inside
    n_in = inside.flatten(1).sum(dim=1).clamp(min=1)
    pen_depth = torch.where(inside, -o2h_signed, 0.0).flatten(1).sum(
        dim=1) / n_in
    pen_frac = inside.to(torch.float32).flatten(1).mean(dim=1)

    # vertex anchor outside the contact region (`:72-78`): a vertex is in
    # contact when its nearest object point lies within 0.5 m; the mask is
    # piecewise constant, so K4 runs outside the graph
    v_sq, _ = nearest_neighbor(verts.detach(), pts.detach())  # [C, T, V]
    w_verts = torch.where(v_sq < 0.25, 0.0, 1e-2)
    loss_verts_reg = ((verts - aux["verts_gt"]).abs().sum(dim=3)
                      * w_verts).sum(dim=2).mean(dim=1)

    losses = []
    for j, static in ((10, aux["left_static"]), (11, aux["right_static"])):
        f = jtr[:, :, j][..., _XZ]
        d = ((f[:, 1:] - f[:, :-1]) ** 2).mean(dim=-1)  # [C, T-1]
        n = static.sum(dim=1).clamp(min=1)
        losses.append((d * static).sum(dim=1) / n)
    loss_left, loss_right = losses

    reg = (0.1 * _mean_from((p["obj_transl"] - aux["anchor_obj_transl"])
                            .abs())
           + 0.1 * _mean_from((p["obj_rot"] - aux["anchor_obj_rot"]).abs())
           + 0.1 * _mean_from((p["transl"] - aux["anchor_transl"]).abs())
           + 0.1 * _mean_from((p["glo_rot"] - aux["anchor_glo_rot"]).abs())
           + 0.005 * _mean_from((p["body_rot"] - aux["anchor_body_rot"])
                                .abs().sum(dim=(2, 3))))

    # body_rot smoothness sums over the joints and the matrix rows before
    # the mean over time and columns (`optimization.py:106`; the JAX
    # package's ``sum(axis=(1, 2))`` of [T, 21, 3, 3])
    br = p["body_rot"]
    br_acc = (br[:, 1:-1] - br[:, :-2]) - (br[:, 2:] - br[:, 1:-1])
    br_vel = br[:, 1:] - br[:, :-1]
    loss_body_v = (1000 * _mean_from((br_acc ** 2).sum(dim=(2, 3)))
                   + 100 * _mean_from((br_vel ** 2).sum(dim=(2, 3)))
                   + 1000 * (loss_left + loss_right))
    loss_v = (_first_second_order(p["transl"], 10, 10)
              + _first_second_order(p["glo_rot"], 5, 5)
              + _first_second_order(p["hand_rot"], 50, 50)
              + _first_second_order(p["obj_transl"], 1000, 100)
              + _first_second_order(p["obj_rot"], 1000, 100)
              + loss_body_v)

    total = loss_dist_o + loss_verts_reg + reg + loss_v
    terms = torch.stack([loss_dist_o, loss_verts_reg, reg, loss_v,
                         pen_depth, pen_frac], dim=1)
    return total, terms


def refiner_init(smpl: SmplModel, cfg: OptimConfig, *, body_pose,
                 hand_pose, body_trans, betas, obj_angles, obj_trans,
                 obj_points):
    """(initial parameters, aux) of a batch of clips: rotation matrices
    from the axis-angle inputs, the gt vertices and the static-foot masks
    from their FK."""
    C, T = body_pose.shape[:2]
    params = {
        "body_rot": axis_angle_to_matrix(body_pose[..., 3:].reshape(
            C, T, -1, 3)),
        "transl": body_trans,
        "glo_rot": axis_angle_to_matrix(body_pose[..., :3].reshape(
            C, T, 1, 3)),
        "obj_transl": obj_trans,
        "obj_rot": axis_angle_to_matrix(obj_angles),
        "hand_rot": axis_angle_to_matrix(hand_pose.reshape(C, T, -1, 3)),
    }
    params = {k: v.detach().clone() for k, v in params.items()}
    with torch.no_grad():
        verts_gt, jtr_gt, _, _ = smpl_forward(
            smpl, torch.cat([body_pose, hand_pose], dim=-1).reshape(C * T, -1),
            betas.reshape(C * T, -1), body_trans.reshape(C * T, 3))
        left, right = _static_feet(jtr_gt.reshape(C, T, -1, 3),
                                   cfg.foot_static_thresh)
    aux = {"verts_gt": verts_gt.reshape(C, T, -1, 3), "left_static": left,
           "right_static": right, "betas": betas, "obj_points": obj_points,
           **{f"anchor_{k}": params[k].clone() for k in
              ("body_rot", "glo_rot", "obj_rot", "transl", "obj_transl")}}
    return params, aux


def descend(smpl: SmplModel, cfg: OptimConfig,
            params: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """``cfg.iters`` Adam steps from ``params`` (of :func:`refiner_init`,
    stepped in place), then the best iterate in axis-angle: per clip
    ``pose`` [C,T,156], ``trans``, ``obj_angles``, ``obj_trans``, the
    parameters after the step whose loss (before the step) was the clip's
    lowest after ``keep_after``, that ``best_loss`` [C] (inf, and the
    starting parameters, when no iteration passed ``keep_after``) and the
    trace ``terms`` [C, iters, len(TERM_NAMES)].  TF32 is turned off: the
    JAX package pins full-f32 products."""
    full_f32()
    C, T = params["transl"].shape[:2]
    device = params["transl"].device
    leaves = [params[k].requires_grad_(True) for k in _PARAMS]
    opt = torch.optim.Adam(leaves, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                           foreach=True)
    best = {k: v.detach().clone() for k, v in params.items()}
    best_loss = torch.full((C,), float("inf"), device=device)
    trace = torch.zeros((C, cfg.iters, len(TERM_NAMES)), device=device)
    denom = np.float32(cfg.ratio_denom)
    with torch.enable_grad():
        for i in range(cfg.iters):
            loss, terms = refiner_loss(smpl, cfg, params,
                                       np.float32(i) / denom, aux)
            opt.zero_grad(set_to_none=True)
            loss.sum().backward()
            opt.step()
            trace[:, i] = terms.detach()
            if i > cfg.keep_after:
                loss = loss.detach()
                take = loss < best_loss
                best_loss = torch.where(take, loss, best_loss)
                for k, v in params.items():
                    shape = (C,) + (1,) * (v.ndim - 1)
                    best[k] = torch.where(take.reshape(shape), v.detach(),
                                          best[k])
    with torch.no_grad():
        pose = torch.cat([matrix_to_axis_angle(best[k]).reshape(C, T, -1)
                          for k in ("glo_rot", "body_rot", "hand_rot")],
                         dim=-1)
        return {"pose": pose, "trans": best["transl"],
                "obj_angles": matrix_to_axis_angle(best["obj_rot"]),
                "obj_trans": best["obj_transl"], "best_loss": best_loss,
                "terms": trace}


def refine_batch(smpl: SmplModel, *, body_pose: torch.Tensor,
                 hand_pose: torch.Tensor, body_trans: torch.Tensor,
                 betas: torch.Tensor, obj_angles: torch.Tensor,
                 obj_trans: torch.Tensor, obj_points: torch.Tensor,
                 cfg: OptimConfig = OptimConfig()) -> Dict[str, torch.Tensor]:
    """Refine a batch of clips, stacked on the leading axis: body_pose
    [C,T,66] (global + body axis-angle), hand_pose [C,T,90], body_trans,
    obj_angles, obj_trans [C,T,3], betas [C,T,10], obj_points [C,P,3];
    :func:`refiner_init`, then :func:`descend`."""
    params, aux = refiner_init(
        smpl, cfg, body_pose=body_pose, hand_pose=hand_pose,
        body_trans=body_trans, betas=betas, obj_angles=obj_angles,
        obj_trans=obj_trans, obj_points=obj_points)
    return descend(smpl, cfg, params, aux)


def optimize_clip(smpl: SmplModel, *, body_pose: torch.Tensor,
                  hand_pose: torch.Tensor, body_trans: torch.Tensor,
                  betas: torch.Tensor, obj_angles: torch.Tensor,
                  obj_trans: torch.Tensor, obj_points: torch.Tensor,
                  cfg: OptimConfig = OptimConfig()) -> Dict[str, torch.Tensor]:
    """Refine one clip (the arrays without the clip axis: body_pose [T,66],
    hand_pose [T,90], ..., obj_points [P,3]); :func:`refine_batch` on a
    batch of one.  ``terms`` is [iters, len(TERM_NAMES)]."""
    out = refine_batch(
        smpl, body_pose=body_pose[None], hand_pose=hand_pose[None],
        body_trans=body_trans[None], betas=betas[None],
        obj_angles=obj_angles[None], obj_trans=obj_trans[None],
        obj_points=obj_points[None], cfg=cfg)
    return {k: v[0] for k, v in out.items()}
