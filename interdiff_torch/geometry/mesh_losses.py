"""Mesh regularisation losses (`interdiff_tpu/geometry/mesh_losses.py`),
contracts of `interdiff/tools.py:92-316`: uniform, cot and cotcurv
Laplacian smoothing, normal consistency, the normal-vector and the
edge-length losses.  They sit on no entry point's path; they belong to the
reference's geometry toolbox.

Every sum over a vertex's neighbours is a scatter-add (`index_add_`) over
edge or face lists built on the host, never a dense [V, V] Laplacian (190
MB at V = 6890).  On the card a scatter-add sums in no fixed order, so the
last bits may change from run to run.  Faces are numpy [F, 3] ints; the
vertices [..., V, 3] float tensors, differentiable.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-16


def _index(x: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=like.device)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


def uniform_laplacian_smoothing(verts: torch.Tensor, faces: np.ndarray
                                ) -> torch.Tensor:
    """Per-vertex |L_u v| where L_u v[i] = mean_{j in N(i)} v_j - v_i
    (`tools.py:92-215`, method='uniform').  verts [..., V, 3] -> [..., V]."""
    V = verts.shape[-2]
    faces = np.asarray(faces)
    edges = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                            faces[:, [0, 2]]], axis=0)
    # undirected unique edges -> both directions
    e = np.unique(np.sort(edges, axis=1), axis=0)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    deg = np.zeros(V, dtype=np.float32)
    np.add.at(deg, src, 1.0)
    deg = torch.as_tensor(np.maximum(deg, 1.0), device=verts.device)

    v = verts.reshape((-1, V, 3))
    acc = torch.zeros_like(v).index_add_(1, _index(src, v),
                                         v[:, _index(dst, v)])
    lap = acc / deg[:, None] - v
    return torch.linalg.norm(lap, dim=-1).reshape(verts.shape[:-1])


def _cotangents(v: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Per-face cotangents of the three angles: v [N, V, 3] -> [N, F, 3]
    (the cotangent at corner 0, 1, 2)."""
    tri = v[:, faces]  # [N, F, 3, 3]
    a = tri[:, :, 1] - tri[:, :, 0]
    b = tri[:, :, 2] - tri[:, :, 0]
    c = tri[:, :, 2] - tri[:, :, 1]
    area2 = torch.linalg.norm(torch.linalg.cross(a, b, dim=-1),
                              dim=-1) + 1e-12  # 2 * area
    # the cotangent at a corner: the dot of its two edges over 2 * area
    cot0 = (a * b).sum(-1) / area2
    cot1 = (-a * c).sum(-1) / area2
    cot2 = (b * c).sum(-1) / area2
    return torch.stack([cot0, cot1, cot2], dim=-1)


def cotcurv_laplacian_norm(verts: torch.Tensor, faces: np.ndarray
                           ) -> torch.Tensor:
    """Per-vertex curvature magnitude, the 'cotcurv' variant of
    `mesh_laplacian_smoothing` (`tools.py:196-215`):
    |(L v - (sum_j w_ij) v) / (4 A_i)| with w_ij = cot a_ij + cot b_ij.
    verts [..., V, 3] -> [..., V]."""
    V = verts.shape[-2]
    v = verts.reshape((-1, V, 3))
    f = _index(faces, v)
    cots = _cotangents(v, f)  # [N, F, 3]
    tri_area = 0.5 * torch.linalg.norm(torch.linalg.cross(
        v[:, f[:, 1]] - v[:, f[:, 0]], v[:, f[:, 2]] - v[:, f[:, 0]],
        dim=-1), dim=-1)
    Lv = torch.zeros_like(v)
    Wsum = v.new_zeros(v.shape[:2])
    areas = v.new_zeros(v.shape[:2])
    # edge (1, 2) is opposite corner 0, and so on
    for k, (i, j) in enumerate(((1, 2), (0, 2), (0, 1))):
        w = cots[..., k]
        Lv = Lv.index_add(1, f[:, i], w[..., None] * v[:, f[:, j]])
        Lv = Lv.index_add(1, f[:, j], w[..., None] * v[:, f[:, i]])
        Wsum = Wsum.index_add(1, f[:, i], w).index_add(1, f[:, j], w)
    for k in range(3):
        areas = areas.index_add(1, f[:, k], tri_area)
    norm_w = 0.25 / areas.clamp(min=1e-12)
    lap = (Lv - Wsum[..., None] * v) * norm_w[..., None]
    return torch.linalg.norm(lap, dim=-1).reshape(verts.shape[:-1])


def laplacian_loss(verts: torch.Tensor, faces: np.ndarray) -> torch.Tensor:
    """`LaplacianLoss` (`tools.py:217-243`): mean cotcurv curvature."""
    return cotcurv_laplacian_norm(verts, faces).mean()


def normal_consistency_loss(verts: torch.Tensor, faces: np.ndarray
                            ) -> torch.Tensor:
    """`NormalConsistencyLoss` (`tools.py:245-260`): mean (1 - cos) between
    the face normals across each shared edge (pytorch3d's
    mesh_normal_consistency); 0 without a shared edge."""
    # edge -> (face, face) adjacency on the host
    edge_map, pairs = {}, []
    for f, face in enumerate(np.asarray(faces)):
        for k in range(3):
            e = tuple(sorted((int(face[k]), int(face[(k + 1) % 3]))))
            if e in edge_map:
                pairs.append((edge_map[e], f))
            else:
                edge_map[e] = f
    if not pairs:
        return verts.new_zeros(())
    pairs = _index(np.asarray(pairs), verts)
    v = verts.reshape((-1,) + verts.shape[-2:])
    tri = v[:, _index(faces, v)]
    n = _unit(torch.linalg.cross(tri[:, :, 1] - tri[:, :, 0],
                                 tri[:, :, 2] - tri[:, :, 0], dim=-1))
    cos = (n[:, pairs[:, 0]] * n[:, pairs[:, 1]]).sum(-1)
    return (1.0 - cos).mean(dim=1).mean()


def normal_vector_loss(coord_out: torch.Tensor, coord_gt: torch.Tensor,
                       faces: np.ndarray) -> torch.Tensor:
    """`NormalVectorLoss` (`tools.py:263-289`): |cos| between the predicted
    edge directions and the gt face normals, meaned.  coord [B, V, 3]."""
    f = _index(faces, coord_out)
    f0, f1, f2 = f[:, 0], f[:, 1], f[:, 2]
    v1o = _unit(coord_out[:, f1] - coord_out[:, f0])
    v2o = _unit(coord_out[:, f2] - coord_out[:, f0])
    v3o = _unit(coord_out[:, f2] - coord_out[:, f1])
    v1g = _unit(coord_gt[:, f1] - coord_gt[:, f0])
    v2g = _unit(coord_gt[:, f2] - coord_gt[:, f0])
    n_g = _unit(torch.linalg.cross(v1g, v2g, dim=-1))
    cos = torch.stack([(v * n_g).sum(-1).abs() for v in (v1o, v2o, v3o)],
                      dim=1)
    return cos.mean()


def edge_length_loss(coord_out: torch.Tensor, coord_gt: torch.Tensor,
                     faces: np.ndarray, *, relative_length: bool = False
                     ) -> torch.Tensor:
    """`EdgeLengthLoss` (`tools.py:291-316`): mean |length difference| of
    the three edges of every face (relative to the gt length when asked).
    coord [B, V, 3]."""
    f = _index(faces, coord_out)

    def d(x, i, j):
        return torch.sqrt(_EPS + ((x[:, f[:, i]] - x[:, f[:, j]]) ** 2)
                          .sum(-1))

    diffs = []
    for i, j in ((0, 1), (0, 2), (1, 2)):
        do, dg = d(coord_out, i, j), d(coord_gt, i, j)
        diff = (do - dg).abs()
        if relative_length:
            diff = diff / dg
        diffs.append(diff)
    return torch.stack(diffs, dim=1).mean()
