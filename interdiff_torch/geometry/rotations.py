"""Rotation representation conversions (`interdiff_tpu/geometry/rotations.py`).

pytorch3d conventions: quaternions are wxyz (the skeleton dataset stores
xyzw; ``quat_xyzw_to_wxyz`` and ``quat_wxyz_to_xyzw`` swap at the
boundary), the 6-D representation is the first two rows of the rotation
matrix, ``matrix_to_quaternion`` picks the best-conditioned candidate, and
``matrix_to_axis_angle`` goes through quaternions (the angle may exceed
pi).  All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import torch


def quat_xyzw_to_wxyz(q: torch.Tensor) -> torch.Tensor:
    """(x, y, z, w) -> (w, x, y, z); cf. `interdiff/model/diffusion_skeleton.py:225`."""
    return torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1)


def quat_wxyz_to_xyzw(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) -> (x, y, z, w); cf. `interdiff/model/correction_skeleton.py:133`."""
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> quaternion (wxyz), with pytorch3d's Taylor guard."""
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half_angles = angles * 0.5
    small = angles.abs() < 1e-6
    safe_angles = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles * angles) / 48.0,
        torch.sin(half_angles) / safe_angles)
    return torch.cat([torch.cos(half_angles),
                      axis_angle * sin_half_over_angle], dim=-1)


def quaternion_to_axis_angle(quaternions: torch.Tensor) -> torch.Tensor:
    """Quaternion (wxyz) -> axis-angle (angle may exceed pi)."""
    norms = torch.linalg.norm(quaternions[..., 1:], dim=-1, keepdim=True)
    half_angles = torch.atan2(norms, quaternions[..., :1])
    angles = 2.0 * half_angles
    small = angles.abs() < 1e-6
    safe_angles = torch.where(small, torch.ones_like(angles), angles)
    sin_half_over_angle = torch.where(
        small, 0.5 - (angles * angles) / 48.0,
        torch.sin(half_angles) / safe_angles)
    return quaternions[..., 1:] / sin_half_over_angle


def quaternion_to_matrix(quaternions: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (wxyz) -> rotation matrix [..., 3, 3]."""
    r, i, j, k = torch.unbind(quaternions, dim=-1)
    two_s = 2.0 / (quaternions * quaternions).sum(dim=-1)
    o = torch.stack([
        1 - two_s * (j * j + k * k),
        two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r),
        1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r),
        two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j),
    ], dim=-1)
    return o.reshape(quaternions.shape[:-1] + (3, 3))


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)), with the gradient routed through the positive branch
    only (sqrt at 0 would turn a zero cotangent into NaN)."""
    positive = x > 0
    safe_x = torch.where(positive, x, torch.ones_like(x))
    return torch.where(positive, torch.sqrt(safe_x), torch.zeros_like(x))


def matrix_to_quaternion(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> quaternion (wxyz).

    Four candidates are formed, one per squared component; the one whose
    defining component is largest (and positive by construction) is kept.
    """
    batch_dim = matrix.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = torch.unbind(
        matrix.reshape(batch_dim + (9,)), dim=-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], dim=-2)
    quat_candidates = quat_by_rijk / (
        2.0 * torch.clamp(q_abs[..., None], min=0.1))
    # select by gather: unselected candidates may carry inf local gradients
    best = torch.argmax(q_abs, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return torch.gather(quat_candidates, -2, idx)[..., 0, :]


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    return quaternion_to_matrix(axis_angle_to_quaternion(axis_angle))


def matrix_to_axis_angle(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    return quaternion_to_axis_angle(matrix_to_quaternion(matrix))


def matrix_to_rotation_6d(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> first two rows flattened [..., 6]."""
    return matrix[..., :2, :].reshape(matrix.shape[:-2] + (6,))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """6-D rep [..., 6] -> rotation matrix [..., 3, 3] by Gram-Schmidt (rows)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(dim=-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def batch_rodrigues_smpl(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] with libsmpl's
    arithmetic (`libsmpl/smplpytorch/pytorch/rodrigues_layer.py:41-52`):
    the angle is the norm of ``aa + 1e-8`` (the bias added to every
    component before the norm), the axis ``aa`` over that angle, through a
    quaternion normalised again before the matrix, so that forward
    kinematics agree with the reference to float32 rounding even at the
    zero pose."""
    angle = torch.linalg.norm(axis_angle + 1e-8, dim=-1, keepdim=True)
    axis = axis_angle / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    quat = quat / torch.linalg.norm(quat, dim=-1, keepdim=True)
    return quaternion_to_matrix(quat)
