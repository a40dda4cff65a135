"""Evaluation metrics of both tracks (`interdiff_tpu/eval/metrics.py`),
contracts from `interdiff/eval_smpl_short.py:24-81` and
`interdiff/train_diffusion_skeleton.py:65-87`.

All batch-first: time is axis 1.  Callers slice to the future frames before
calling.  The `penetrate` term sweeps every object point of every frame
against the body's vertices: on CUDA tensors that is one launch of kernel
K3 (`ops/nn.py::signed_nearest_cuda`), or of K2 when ``nn_prune_delta`` opts
into the pruned sweep.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from interdiff_torch.geometry.normals import vertex_normals
from interdiff_torch.geometry.rotations import (
    axis_angle_to_matrix,
    axis_angle_to_quaternion,
)
from interdiff_torch.ops.signed_distance import (
    signed_nearest,
    signed_nearest_pruned,
)


def quat_min_error(q_pred: torch.Tensor, q_gt: torch.Tensor, *,
                   ord: int = 1) -> torch.Tensor:
    """Sign-invariant quaternion error min(|q - q'|, |q + q'|) over the last
    axis (L1 for the SMPL track, L2 for the skeleton track)."""
    e1 = torch.linalg.vector_norm(q_pred - q_gt, ord=ord, dim=-1)
    e2 = torch.linalg.vector_norm(q_pred + q_gt, ord=ord, dim=-1)
    return torch.minimum(e1, e2)


def smpl_metrics(
    obj_pred: torch.Tensor,  # [B, T, 6] axis-angle (3) + trans (3)
    body_jtr: torch.Tensor,  # [B, T, J, 3]
    body: torch.Tensor,  # [B, T, D] (last 3 = trans)
    obj_gt: torch.Tensor,  # [B, T, 6]
    body_jtr_gt: torch.Tensor,
    body_gt: torch.Tensor,
    verts: torch.Tensor,  # [B, T, V, 3]
    faces: Union[np.ndarray, torch.Tensor],  # [F, 3]
    obj_points: torch.Tensor,  # [B, P, 3] canonical template xyz
    *, nn_chunk: Optional[int] = 512,
    nn_prune_delta: Optional[float] = None,
    incident: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Per-sample metric dict, each [B] (`eval_smpl_short.py:24-81`).

    `penetrate` is the share of object points whose pseudonormal sign at the
    nearest body vertex is negative.  The default is the full sweep, the
    sign test the reference's metric is defined by: it reports negative
    signs for some points far outside a posed body (concave folds), and
    those far-field signs are part of the metric.  ``nn_prune_delta`` (e.g.
    0.25) opts into the pruned sweep, which forces every point farther than
    delta from the body to the outside: faster and closer to the geometric
    truth, but another number.  ``incident`` is the body's face-incidence
    table (`SmplModel.incident`), built from ``faces`` when not given.
    """
    B, T = obj_pred.shape[:2]

    rot = axis_angle_to_matrix(obj_pred[..., :3])  # [B, T, 3, 3]
    obj_points_pred = (torch.einsum("btij,bpj->btpi", rot, obj_points)
                       + obj_pred[..., None, 3:])

    v_flat = verts.reshape(B * T, -1, 3)
    normals = vertex_normals(v_flat, faces, incident)
    queries = obj_points_pred.reshape(B * T, -1, 3)
    if nn_prune_delta is not None:
        _, o2h_dot = signed_nearest_pruned(
            queries, v_flat, normals, delta=nn_prune_delta, chunk=nn_chunk)
    else:
        _, o2h_dot = signed_nearest(queries, v_flat, normals, chunk=nn_chunk)
    penetrate = (o2h_dot < 0).reshape(B, -1).to(torch.float32).mean(dim=1)

    global_mpjpe = torch.linalg.norm(body_jtr - body_jtr_gt, dim=-1
                                     ).mean(dim=(1, 2))
    local = body_jtr - body_jtr[:, :, 0:1]
    local_gt = body_jtr_gt - body_jtr_gt[:, :, 0:1]
    local_mpjpe = torch.linalg.norm(local - local_gt, dim=-1).mean(dim=(1, 2))

    body_translation = torch.linalg.norm(
        body[..., -3:] - body_gt[..., -3:], dim=-1).mean(dim=1)
    obj_translation = torch.linalg.norm(
        obj_pred[..., -3:] - obj_gt[..., -3:], dim=-1).mean(dim=1)

    q_pred = axis_angle_to_quaternion(obj_pred[..., :3])
    q_gt = axis_angle_to_quaternion(obj_gt[..., :3])
    obj_rot_error = quat_min_error(q_pred, q_gt, ord=1).mean(dim=1)

    return {
        "global_mpjpe": global_mpjpe,
        "local_mpjpe": local_mpjpe,
        "body_translation": body_translation,
        "obj_translation": obj_translation,
        "obj_rot_error": obj_rot_error,
        "penetrate": penetrate,
    }


def skeleton_metrics(
    body_pred: torch.Tensor,  # [B, T, J, 3]
    body_gt: torch.Tensor,
    obj_pred: torch.Tensor,  # [B, T, P, 3]
    obj_gt: torch.Tensor,
    pose_pred: torch.Tensor,  # [B, T, 7]
    pose_gt: torch.Tensor,
    *, start: int = 10,
) -> Dict[str, torch.Tensor]:
    """Scalar metric dict over frames ``start:``
    (`train_diffusion_skeleton.py:65-87`)."""
    s = start
    mpjpe_h = torch.linalg.norm(body_pred[:, s:] - body_gt[:, s:],
                                dim=-1).mean()
    mpjpe_o = torch.linalg.norm(obj_pred[:, s:] - obj_gt[:, s:],
                                dim=-1).mean()
    translation_error = torch.linalg.norm(
        pose_pred[:, s:, :3] - pose_gt[:, s:, :3], dim=-1).mean()
    rotation_error = quat_min_error(
        pose_pred[:, s:, -4:], pose_gt[:, s:, -4:], ord=2).mean()
    return {
        "mpjpe_h": mpjpe_h,
        "mpjpe_o": mpjpe_o,
        "translation_error": translation_error,
        "rotation_error": rotation_error,
    }


def smooth_seam(x: torch.Tensor, future_len: int) -> torch.Tensor:
    """C1-continuity fix at the past/future seam (`eval_smpl_short.py:217-223`):
    every future frame is shifted by the extrapolation residual.  Batch
    first, time on axis 1; returns a new tensor and leaves ``x`` as it is."""
    F = future_len
    delta = 2 * x[:, -F - 1] - x[:, -F - 2] - x[:, -F]
    return torch.cat([x[:, :-F], x[:, -F:] + delta[:, None]], dim=1)
