"""Shared set-up of the SMPL entry points (`interdiff_tpu/cli/common.py`).
This slice holds the stand-in body only; the argument parsers and loaders
come with the eval CLI."""

from __future__ import annotations

import numpy as np

from interdiff_torch.smpl.model import SmplModel


def synthetic_smpl_body(rng: np.random.Generator, *, num_verts: int = 128,
                        num_joints: int = 52, device=None) -> SmplModel:
    """SMPL-H-shaped stand-in body (real pkls are not shipped): the same
    array shapes and kinematic-tree depth, and the same arrays from the same
    ``rng`` as `interdiff_tpu/cli/common.py::synthetic_smpl_body`.

    The template is a closed watertight surface (a Fibonacci-sphere
    ellipsoid triangulated by its convex hull, 2V-4 faces: V=6890 gives the
    real SMPL-H's 13776) with spatially smooth skinning weights (softmax
    over per-joint surface anchors), so that skinned vertices stay a
    coherent surface and signed distances behave as on a real body.
    """
    from scipy.spatial import ConvexHull

    V, J = num_verts, num_joints
    parents = np.zeros(J, dtype=np.int64)
    for j in range(1, J):
        parents[j] = (j - 1) // 2

    # Fibonacci sphere -> human-proportioned ellipsoid with smooth bumps
    i = np.arange(V, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    y = 1.0 - 2.0 * (i + 0.5) / V
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    unit = np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=1)
    hull = ConvexHull(unit)
    faces = hull.simplices.astype(np.int32)
    # orient every triangle outward (hull simplices are unordered)
    tri = unit[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("fi,fi->f", n, tri.mean(axis=1)) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    bump = 1.0 + 0.08 * np.sin(3.0 * phi + rng.random() * 6.28) \
        * np.cos(2.0 * np.arccos(np.clip(y, -1, 1)))
    v_template = (unit * bump[:, None]
                  * np.array([0.25, 0.85, 0.15])).astype(np.float64)

    # smooth weights: joints anchored on the surface, soft nearest-anchor
    anchors = v_template[rng.choice(V, size=J, replace=V < J)]
    d2 = ((v_template[:, None] - anchors[None]) ** 2).sum(-1)
    w = np.exp(-d2 / 0.02)
    w /= w.sum(1, keepdims=True)
    jr = np.exp(-d2.T / 0.005)
    jr /= jr.sum(1, keepdims=True)

    return SmplModel.create(
        v_template=v_template,
        shapedirs=rng.standard_normal((V, 3, 10)) * 0.01,
        posedirs=rng.standard_normal((V, 3, 9 * (J - 1))) * 0.001,
        j_regressor=jr, weights=w, parents=parents, faces=faces,
        device=device)
