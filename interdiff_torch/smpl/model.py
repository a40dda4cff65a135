"""SMPL / SMPL-H linear-blend-skinning forward kinematics
(`interdiff_tpu/smpl/model.py`), contract of
`interdiff/libsmpl/smplpytorch/pytorch/smpl_layer.py:72-175`: shape
blendshapes -> pose blendshapes from (R - I) of the non-root joints -> FK
down the kinematic tree -> rest-pose removal -> LBS, returning
``(verts, joints, v_posed, naked)`` with the translation added at the end.

FK walks the tree by depth level: joints of one depth compose with their
parents in one batched product, so the 52-joint SMPL-H tree needs only as
many sequential rounds as it is deep.  Skinning is one [V, J] x [B, J, 12]
product.  Every product is a plain `torch.einsum` in full float32; callers
that need parity keep TF32 off (`eval/smpl_short.py` does).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from interdiff_torch import resolve_device
from interdiff_torch.geometry.normals import _face_incidence
from interdiff_torch.geometry.rotations import axis_angle_to_matrix


def _depth_levels(parents: np.ndarray) -> List[np.ndarray]:
    """Group joint indices by depth in the kinematic tree (root = level 0)."""
    J = len(parents)
    depth = np.zeros(J, dtype=np.int64)
    for j in range(1, J):
        depth[j] = depth[parents[j]] + 1
    return [np.where(depth == d)[0] for d in range(depth.max() + 1)]


class SmplModel(nn.Module):
    """Static model tensors as float32 buffers; ``parents`` [J], ``faces``
    [F, 3] and ``levels`` stay numpy on the host.  ``faces_idx`` and
    ``incident`` are the device copies that `vertex_normals` gathers with."""

    def __init__(self, *, v_template, shapedirs, posedirs, j_regressor,
                 weights, parents, faces, device=None):
        super().__init__()
        parents = np.array(parents, dtype=np.int64)
        parents[0] = 0  # pkl stores 2**32-1 / -1 for the root
        self.parents = parents
        self.faces = np.asarray(faces, dtype=np.int32)
        self.levels = tuple(tuple(int(j) for j in lvl)
                            for lvl in _depth_levels(parents))
        for name, value in (("v_template", v_template),  # [V, 3]
                            ("shapedirs", shapedirs),  # [V, 3, num_betas]
                            ("posedirs", posedirs),  # [V, 3, 9*(J-1)]
                            ("j_regressor", j_regressor),  # [J, V]
                            ("weights", weights)):  # [V, J]
            self.register_buffer(name, torch.as_tensor(
                np.array(value, dtype=np.float32)))
        self.register_buffer("faces_idx", torch.as_tensor(
            self.faces.astype(np.int64)))
        self.register_buffer("incident", torch.as_tensor(_face_incidence(
            self.faces, self.v_template.shape[0]).astype(np.int64)))
        self.to(resolve_device(device))

    @classmethod
    def create(cls, *, v_template, shapedirs, posedirs, j_regressor, weights,
               parents, faces, device=None) -> "SmplModel":
        """Build the model from numpy arrays (float64 in the pkls), on
        ``device`` (CUDA unless given)."""
        return cls(v_template=v_template, shapedirs=shapedirs,
                   posedirs=posedirs, j_regressor=j_regressor,
                   weights=weights, parents=parents, faces=faces,
                   device=device)

    @property
    def num_joints(self) -> int:
        return int(self.j_regressor.shape[0])

    @property
    def num_verts(self) -> int:
        return int(self.v_template.shape[0])


def smpl_forward(model: SmplModel, pose_axisang: torch.Tensor,
                 betas: torch.Tensor, trans: torch.Tensor, *,
                 offsets: Optional[torch.Tensor] = None, scale: float = 1.0):
    """LBS forward.  pose_axisang [B, 3*J], betas [B, num_betas], trans
    [B, 3] -> ``(verts [B,V,3], joints [B,J,3], v_posed [B,V,3], naked
    [B,V,3])``, the quadruple of the reference ``SMPL_Layer.forward``."""
    B = pose_axisang.shape[0]
    J = model.num_joints
    parents = model.parents

    rots = axis_angle_to_matrix(pose_axisang.reshape(B, J, 3))  # [B,J,3,3]

    # shape blendshapes (`smpl_layer.py:96-103`)
    v_shaped = model.v_template + torch.einsum(
        "vdk,bk->bvd", model.shapedirs, betas)
    joints0 = torch.einsum("jv,bvd->bjd", model.j_regressor, v_shaped)

    # pose blendshapes from (R - I) of the non-root joints (`:105-107`)
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    pose_map = (rots[:, 1:] - eye).reshape(B, -1)  # [B, 9*(J-1)]
    naked = v_shaped + torch.einsum("vdp,bp->bvd", model.posedirs, pose_map)
    v_posed = naked if offsets is None else naked + offsets

    # FK by depth level: R_g / t_g hold global rotation and translation
    rel_t = joints0 - joints0[:, parents]  # [B,J,3]
    rel_t[:, 0] = joints0[:, 0]

    R_g = eye.expand(B, J, 3, 3).clone()
    t_g = torch.zeros((B, J, 3), dtype=rots.dtype, device=rots.device)
    R_g[:, 0] = rots[:, 0]
    t_g[:, 0] = rel_t[:, 0]
    for level in model.levels[1:]:
        idx = list(level)
        par = parents[idx]
        Rp, tp = R_g[:, par], t_g[:, par]
        R_g[:, idx] = torch.einsum("bjxy,bjyz->bjxz", Rp, rots[:, idx])
        t_g[:, idx] = torch.einsum("bjxy,bjy->bjx", Rp, rel_t[:, idx]) + tp

    joints = t_g  # [B,J,3] global joint positions

    # rest-pose removal (`:135-144`): T'_j = [R_g | t_g - R_g @ j0]
    t_skin = t_g - torch.einsum("bjxy,bjy->bjx", R_g, joints0)

    # LBS: weights [V,J] x per-joint affine [B,J,12]
    affine = torch.cat([R_g.reshape(B, J, 9), t_skin], dim=-1)  # [B,J,12]
    blended = torch.einsum("vj,bjc->bvc", model.weights, affine)
    R_v = blended[..., :9].reshape(B, -1, 3, 3)
    t_v = blended[..., 9:]
    # an elementwise product and sum: as an einsum this is B*V batched 3x3
    # matrix-vector products, which the card runs one tiny gemv at a time
    verts = (R_v * v_posed.unsqueeze(-2)).sum(dim=-1) + t_v

    if scale != 1.0:
        verts = verts * scale
        joints = joints * scale
    verts = verts + trans[:, None]
    joints = joints + trans[:, None]
    return verts, joints, v_posed, naked
