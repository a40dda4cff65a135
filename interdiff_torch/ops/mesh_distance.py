"""Point-to-triangle-mesh signed distance on the device of its tensors
(`interdiff_tpu/ops/mesh_distance.py`), the replacement for
`igl.signed_distance` in the offline contact-label generator
(`interdiff/data/prepare_behave.py:42`).

The closest point on every triangle follows Ericson's barycentric regions
with the JAX package's order of overrides (interior, then the edges AB, AC,
BC, then the vertices A, B, C last); every dot product is written out as
products and sums of the three components, so no matrix unit, TF32 or
order of a GEMM's summation can reach them, and the card computes the same
rounded operations as the CPU.  The search is a brute force over the
faces, ``face_chunk`` at a time: the first minimum within a chunk, a
strictly smaller one across chunks, so the result does not depend on the
chunk.  The sign is that of the angle-weighted pseudonormal of the closest
primitive (Baerentzen & Aanaes 2005, as igl does): the vertex's normal when
the closest point sits on a vertex, the shared normal of an edge on an
edge, else the face's; the normals in float64, vectorised over faces and
points (`_pseudonormals`).

Every function takes leading batch axes: points [..., N, 3] against the
vertices [..., V, 3] of meshes that share one face list [F, 3] (the frames
of one body).  A batch of frames gives each frame what it alone gives.
No Pallas kernel stands behind this in the JAX package, so the port adds
none: it is plain PyTorch, the same code on the card and on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from interdiff_torch import resolve_device


def _dot(u, v):
    """Sum of the products of three components, in index order."""
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _nonzero(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def closest_point_on_triangles(p: torch.Tensor, tri: torch.Tensor
                               ) -> torch.Tensor:
    """Closest point of each triangle to each point.

    p [..., N, 3], tri [..., F, 3, 3] -> [..., N, F, 3].
    """
    # components: points [..., N, 1], corners [..., 1, F]
    P = [p[..., :, None, k] for k in range(3)]
    A, B, C = ([tri[..., None, :, j, k] for k in range(3)] for j in range(3))
    ab = [B[k] - A[k] for k in range(3)]
    ac = [C[k] - A[k] for k in range(3)]
    ap = [P[k] - A[k] for k in range(3)]
    bp = [P[k] - B[k] for k in range(3)]
    cp = [P[k] - C[k] for k in range(3)]
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    del ap, bp, cp  # [..., N, F] each: the search's memory is its pairs
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    v_ab = (d1 / _nonzero(d1 - d3)).clamp(0.0, 1.0)
    w_ac = (d2 / _nonzero(d2 - d6)).clamp(0.0, 1.0)
    num_bc = d4 - d3
    w_bc = (num_bc / _nonzero((d4 - d3) + (d5 - d6))).clamp(0.0, 1.0)
    denom = _nonzero(va + vb + vc)
    v_in, w_in = vb / denom, vc / denom

    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)
    at_a = (d1 <= 0) & (d2 <= 0)
    at_b = (d3 >= 0) & (d4 <= d3)
    at_c = (d6 >= 0) & (d5 <= d6)
    out = []
    for k in range(3):
        o = A[k] + v_in * ab[k] + w_in * ac[k]
        o = torch.where(in_ab, A[k] + v_ab * ab[k], o)
        o = torch.where(in_ac, A[k] + w_ac * ac[k], o)
        o = torch.where(in_bc, B[k] + w_bc * (C[k] - B[k]), o)
        # the vertex regions last: they take precedence
        o = torch.where(at_a, A[k].expand_as(o), o)
        o = torch.where(at_b, B[k].expand_as(o), o)
        o = torch.where(at_c, C[k].expand_as(o), o)
        out.append(o)
    return torch.stack(out, dim=-1)


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, summed in index order."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / _norm3(x).clamp(min=1e-12)[..., None]


def _pseudonormals(verts: torch.Tensor, faces: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Face normals [..., F, 3], angle-weighted vertex normals [..., V, 3],
    the normals of the mesh's edges [..., E, 3] (the sum of the normals of
    the faces that share an edge) and ``edge_of`` [F, 3], the index of the
    edge from corner k to corner k+1 of each face; of the vertices [...,
    V, 3] in their dtype (float64 for the sign)."""
    tri = verts[..., faces, :]  # [..., F, 3, 3]
    fn = _unit(torch.linalg.cross(tri[..., 1, :] - tri[..., 0, :],
                                  tri[..., 2, :] - tri[..., 0, :], dim=-1))
    vn = torch.zeros_like(verts)
    axis = verts.ndim - 2
    for k in range(3):
        i = faces[:, k]
        e1 = tri[..., (k + 1) % 3, :] - tri[..., k, :]
        e2 = tri[..., (k + 2) % 3, :] - tri[..., k, :]
        cosang = (e1 * e2).sum(-1) / (_norm3(e1) * _norm3(e2)).clamp(
            min=1e-12)
        ang = torch.arccos(cosang.clamp(-1.0, 1.0))
        vn.index_add_(axis, i, fn * ang[..., None])
    vn = _unit(vn)

    # each face's edges (k, k+1) as sorted vertex pairs, face by face
    pairs = torch.stack([faces, faces.roll(-1, dims=1)], dim=-1)  # [F,3,2]
    pairs = pairs.sort(dim=-1).values.reshape(-1, 2)
    _, edge_of = torch.unique(pairs, dim=0, return_inverse=True)
    n_edges = int(edge_of.max()) + 1
    en = torch.zeros(verts.shape[:-2] + (n_edges, 3), dtype=verts.dtype,
                     device=verts.device)
    en.index_add_(axis, edge_of, fn.repeat_interleave(3, dim=axis))
    return fn, vn, _unit(en), edge_of.reshape(-1, 3)


def _as_device_tensors(points, verts, faces, device):
    if isinstance(points, torch.Tensor):
        device = points.device
    else:
        device = resolve_device(device)

    def on_device(x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)

    return (on_device(points).to(torch.float32), on_device(verts),
            on_device(faces).to(torch.int64))


def signed_distance_to_mesh(points, verts, faces, *, face_chunk: int = 2048,
                            device=None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """igl-compatible signed distance: points [..., N, 3] against the mesh
    (verts [..., V, 3], faces [F, 3]) -> (signed distance [..., N] float32,
    negative inside; closest face [..., N] int64; closest point [..., N, 3]
    float32).

    Runs on the device of ``points`` when it is a tensor, else on
    ``resolve_device(device)`` (CUDA unless named).  The distances are
    computed from the float32 vertices, the sign from their float64 copy,
    as the JAX package does.
    """
    points, verts, faces = _as_device_tensors(points, verts, faces, device)
    verts32 = verts.to(torch.float32)
    N, F = points.shape[-2], faces.shape[0]
    batch = points.shape[:-2]
    best_d = torch.full(batch + (N,), float("inf"), device=points.device)
    best_f = torch.zeros(batch + (N,), dtype=torch.int64,
                         device=points.device)
    best_cp = torch.zeros(batch + (N, 3), device=points.device)
    for s in range(0, F, face_chunk):
        tri = verts32[..., faces[s:s + face_chunk], :]  # [..., f, 3, 3]
        cp = closest_point_on_triangles(points, tri)  # [..., N, f, 3]
        d = _norm3(points[..., :, None, :] - cp)
        dmin, idx = d.min(dim=-1)  # the first minimum of the chunk
        take = dmin < best_d
        best_d = torch.where(take, dmin, best_d)
        best_f = torch.where(take, idx + s, best_f)
        at = cp.gather(-2, idx[..., None, None].expand(
            idx.shape + (1, 3)))[..., 0, :]
        best_cp = torch.where(take[..., None], at, best_cp)
        del cp, d

    return (_signs(points, verts, faces, best_f, best_cp) * best_d, best_f,
            best_cp)


def _signs(points, verts, faces, best_f, best_cp, eps: float = 1e-6
           ) -> torch.Tensor:
    """+1 outside (or on), -1 inside, by the pseudonormal of the closest
    primitive, the rule of `interdiff_tpu/ops/mesh_distance.py:146-172`."""
    fn, vn, en, edge_of = _pseudonormals(verts.to(torch.float64), faces)
    face = faces[best_f]  # [..., N, 3]
    # the closest point's barycentric coordinates in the float32 triangle
    tri = torch.stack([_take_rows(verts.to(torch.float32), face[..., j])
                       for j in range(3)], dim=-2)  # [..., N, 3, 3]
    v0 = tri[..., 1, :] - tri[..., 0, :]
    v1 = tri[..., 2, :] - tri[..., 0, :]
    v2 = best_cp - tri[..., 0, :]
    c = lambda u: [u[..., k] for k in range(3)]  # noqa: E731
    d00, d01, d11 = _dot(c(v0), c(v0)), _dot(c(v0), c(v1)), _dot(c(v1), c(v1))
    d20, d21 = _dot(c(v2), c(v0)), _dot(c(v2), c(v1))
    den = (d00 * d11 - d01 * d01).clamp(min=1e-18)
    v = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    bary = torch.stack([1.0 - v - w, v, w], dim=-1)

    on_vertex = (bary > 1 - eps).any(dim=-1)
    near_zero = bary < eps
    on_edge = near_zero.any(dim=-1) & ~on_vertex
    corner = bary.argmax(dim=-1, keepdim=True)
    n_vertex = _take_rows(vn, face.gather(-1, corner)[..., 0])
    # the first zero coordinate's corner k: the edge opposite, k+1 -> k+2
    k = near_zero.to(torch.int8).argmax(dim=-1)
    n_edge = _take_rows(en, edge_of[best_f, (k + 1) % 3])
    n_face = _take_rows(fn, best_f)
    n = torch.where(on_vertex[..., None], n_vertex,
                    torch.where(on_edge[..., None], n_edge, n_face))
    diff = (points - best_cp).to(torch.float64)
    outside = _dot(c(diff), c(n)) >= 0
    return torch.where(outside, 1.0, -1.0).to(torch.float32)


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [..., R, C] at idx [..., N] -> [..., N, C], batch by batch."""
    return table.gather(-2, idx[..., None].expand(idx.shape
                                                  + table.shape[-1:]))
