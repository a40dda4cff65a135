"""Rotations, SMPL-H forward kinematics, vertex normals and the plain
nearest-neighbour searches of the reference."""

from __future__ import annotations

import numpy as np
import torch


def quat_to_matrix(q):
    """Unit quaternion (wxyz) [..., 4] -> [..., 3, 3]."""
    r, i, j, k = q.unbind(-1)
    s = 2.0 / (q * q).sum(-1)
    m = torch.stack([
        1 - s * (j * j + k * k), s * (i * j - k * r), s * (i * k + j * r),
        s * (i * j + k * r), 1 - s * (i * i + k * k), s * (j * k - i * r),
        s * (i * k - j * r), s * (j * k + i * r), 1 - s * (i * i + j * j),
    ], -1)
    return m.reshape(q.shape[:-1] + (3, 3))


def aa_to_quat(aa):
    angle = torch.linalg.norm(aa, dim=-1, keepdim=True)
    small = angle.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angle), angle)
    f = torch.where(small, 0.5 - angle * angle / 48.0,
                    torch.sin(angle * 0.5) / safe)
    return torch.cat([torch.cos(angle * 0.5), aa * f], -1)


def aa_to_matrix(aa):
    return quat_to_matrix(aa_to_quat(aa))


def matrix_to_quat(m):
    """pytorch3d's best-conditioned candidate, wxyz."""
    shape = m.shape[:-2]
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.reshape(
        shape + (9,)).unbind(-1)
    x = torch.stack([1 + m00 + m11 + m22, 1 + m00 - m11 - m22,
                     1 - m00 + m11 - m22, 1 - m00 - m11 + m22], -1)
    q_abs = torch.where(x > 0, torch.sqrt(torch.where(x > 0, x, 1.0)), 0.0)
    cand = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], -1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], -1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], -1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], -1),
    ], -2) / (2.0 * q_abs[..., None].clamp(min=0.1))
    best = q_abs.argmax(-1)
    return cand.gather(-2, best[..., None, None].expand(
        best.shape + (1, 4)))[..., 0, :]


def quat_to_aa(q):
    norms = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    half = torch.atan2(norms, q[..., :1])
    angle = 2.0 * half
    small = angle.abs() < 1e-6
    safe = torch.where(small, torch.ones_like(angle), angle)
    f = torch.where(small, 0.5 - angle * angle / 48.0, torch.sin(half) / safe)
    return q[..., 1:] / f


def matrix_to_aa(m):
    return quat_to_aa(matrix_to_quat(m))


def matrix_to_6d(m):
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


def sixd_to_matrix(d6):
    """Gram-Schmidt on the two rows."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -2)


def xyzw_to_wxyz(q):
    return torch.cat([q[..., 3:], q[..., :3]], -1)


def wxyz_to_xyzw(q):
    return torch.cat([q[..., 1:], q[..., :1]], -1)


def smpl_fk(body, pose_aa, betas, trans):
    """Linear blend skinning, joint by joint down the tree.  ``body`` holds
    the arrays of the stand-in (float32 tensors and numpy ``parents``);
    pose_aa [B, 3J], betas [B, 10], trans [B, 3] -> (verts [B, V, 3],
    joints [B, J, 3])."""
    B = pose_aa.shape[0]
    parents = body["parents"]
    J = len(parents)
    rots = aa_to_matrix(pose_aa.reshape(B, J, 3))
    v_shaped = body["v_template"] + torch.einsum(
        "vdk,bk->bvd", body["shapedirs"], betas)
    j0 = torch.einsum("jv,bvd->bjd", body["j_regressor"], v_shaped)
    eye = torch.eye(3, dtype=rots.dtype, device=rots.device)
    v_posed = v_shaped + torch.einsum(
        "vdp,bp->bvd", body["posedirs"], (rots[:, 1:] - eye).reshape(B, -1))
    R = [rots[:, 0]]
    t = [j0[:, 0]]
    for j in range(1, J):
        p = int(parents[j])
        R.append(R[p] @ rots[:, j])
        t.append((R[p] @ (j0[:, j] - j0[:, p])[..., None])[..., 0] + t[p])
    R = torch.stack(R, 1)
    t = torch.stack(t, 1)
    t_skin = t - (R @ j0[..., None])[..., 0]
    affine = torch.cat([R.reshape(B, J, 9), t_skin], -1)
    blend = torch.einsum("vj,bjc->bvc", body["weights"], affine)
    rot = blend[..., :9].reshape(B, -1, 3, 3)
    verts = (rot @ v_posed[..., None])[..., 0] + blend[..., 9:]
    return verts + trans[:, None], t + trans[:, None]


def face_incidence(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """[V, K] incident face ids, padded with F (a zero normal)."""
    lists = [[] for _ in range(num_verts)]
    for f, tri in enumerate(faces):
        for v in tri:
            lists[int(v)].append(f)
    K = max(len(x) for x in lists)
    out = np.full((num_verts, K), len(faces), dtype=np.int64)
    for v, x in enumerate(lists):
        out[v, :len(x)] = x
    return out


def vertex_normals(verts, faces, incident):
    """Area-weighted normals: the cross products of each vertex's faces,
    summed in a fixed order, normalised (denominator at least 1e-6)."""
    c0 = verts[:, faces[:, 0]]
    fn = torch.linalg.cross(verts[:, faces[:, 1]] - c0,
                            verts[:, faces[:, 2]] - c0, dim=-1)
    fn = torch.cat([fn, torch.zeros_like(fn[:, :1])], 1)
    n = fn[:, incident[:, 0]]
    for k in range(1, incident.shape[1]):
        n = n + fn[:, incident[:, k]]
    return n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-6)


def nearest(a, b, block: int = 32):
    """For each a-point [F, N, 3] the nearest b-point [F, M, 3]: (squared
    distance [F, N], index [F, N]).  The index is the first least
    |b|^2 - 2 a.b over the whole surface, in blocks of frames; the distance
    is |a - b|^2 at that point."""
    bb = (b * b).sum(-1)
    idx = torch.cat([
        (bb[s:s + block, None] - 2.0 * (a[s:s + block]
                                        @ b[s:s + block].transpose(1, 2))
         ).argmin(-1) for s in range(0, a.shape[0], block)])
    near = b.gather(1, idx[..., None].expand(idx.shape + (3,)))
    return ((a - near) ** 2).sum(-1), idx


def signed_nearest(a, b, n, block: int = 32):
    """(squared distance, n[j*] . (a - b[j*])) at the nearest b-point."""
    sq, idx = nearest(a, b, block)
    g = idx[..., None].expand(idx.shape + (3,))
    return sq, (n.gather(1, g) * (a - b.gather(1, g))).sum(-1)
