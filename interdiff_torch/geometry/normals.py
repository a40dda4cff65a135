"""Vertex normals by area-weighted face-normal accumulation
(`interdiff_tpu/geometry/normals.py`), equivalent to the reference's
scatter-add (`interdiff/data/tools.py:4-40`): each vertex sums the cross
products of its incident faces (the three corner contributions of a
triangle are the same vector), then normals are L2-normalised with the
denominator clamped at 1e-6.

The sum is a gather over a precomputed [V, K] incidence table (K = the
largest vertex degree), added in a fixed order.  It is not an `index_add_`:
scatter-adds on the card use atomics whose order changes from run to run,
and the sign of the pseudonormal dot feeds discrete gate decisions.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def _face_incidence(faces: np.ndarray, num_verts: int) -> np.ndarray:
    """[V, K] ids of the faces incident to each vertex (pad value = F)."""
    F = faces.shape[0]
    flat = faces.reshape(-1).astype(np.int64)  # corner c of face f at 3f+c
    order = np.argsort(flat, kind="stable")
    sorted_v = flat[order]
    sorted_f = (order // 3).astype(np.int32)
    counts = np.bincount(flat, minlength=num_verts)
    K = int(counts.max()) if counts.size else 0
    starts = np.zeros(num_verts, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(flat.size, dtype=np.int64) - starts[sorted_v]
    incident = np.full((num_verts, max(K, 1)), F, dtype=np.int32)
    incident[sorted_v, pos] = sorted_f
    return incident


def vertex_normals(vertices: torch.Tensor,
                   faces: Union[np.ndarray, torch.Tensor],
                   incident: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-vertex unit normals.

    vertices [..., V, 3]; faces [F, 3] ints shared across the batch (numpy,
    or an int64 tensor on the vertices' device); ``incident`` the int64
    [V, K] table of :func:`_face_incidence` on that device, built here when
    not given (`SmplModel` keeps both as buffers) -> [..., V, 3].
    """
    batch_shape = vertices.shape[:-2]
    V = vertices.shape[-2]
    v = vertices.reshape((-1, V, 3))
    if incident is None:
        faces_np = (faces if isinstance(faces, np.ndarray)
                    else faces.cpu().numpy())
        incident = torch.as_tensor(
            _face_incidence(faces_np, V).astype(np.int64), device=v.device)
    faces = torch.as_tensor(faces, dtype=torch.int64, device=v.device)

    c0 = v[:, faces[:, 0]]
    a = v[:, faces[:, 1]] - c0  # [B, F, 3]
    b = v[:, faces[:, 2]] - c0
    fn = torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                      a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                      a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)
    fn = torch.cat([fn, fn.new_zeros((fn.shape[0], 1, 3))], dim=1)  # pad id F
    n = fn[:, incident[:, 0]]
    for k in range(1, incident.shape[1]):  # fixed order: run-to-run equal
        n = n + fn[:, incident[:, k]]
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    out = n / norm.clamp(min=1e-6)
    return out.reshape(batch_shape + (V, 3))
