"""The SMPL-H stand-in body at SMPL-H's sizes, made from a seed (the
licensed model files are not in the repository): a closed ellipsoid
surface of ``num_verts`` vertices (2V - 4 faces: 13,776 at V = 6890) with
smooth skinning weights over a 52-joint tree as deep as SMPL-H's.  The
arrays go to the program through its body constructor and to the reference
as they are."""

from __future__ import annotations

import numpy as np


def stand_in_arrays(rng: np.random.Generator, num_verts: int,
                    num_joints: int) -> dict:
    from scipy.spatial import ConvexHull

    V, J = num_verts, num_joints
    parents = np.zeros(J, dtype=np.int64)
    parents[1:] = (np.arange(1, J) - 1) // 2
    i = np.arange(V, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    y = 1.0 - 2.0 * (i + 0.5) / V
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    unit = np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=1)
    faces = ConvexHull(unit).simplices.astype(np.int32)
    tri = unit[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("fi,fi->f", n, tri.mean(axis=1)) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    bump = 1.0 + 0.08 * np.sin(3.0 * phi + rng.random() * 6.28) \
        * np.cos(2.0 * np.arccos(np.clip(y, -1, 1)))
    v_template = unit * bump[:, None] * np.array([0.25, 0.85, 0.15])
    anchors = v_template[rng.choice(V, size=J, replace=V < J)]
    d2 = ((v_template[:, None] - anchors[None]) ** 2).sum(-1)
    w = np.exp(-d2 / 0.02)
    w /= w.sum(1, keepdims=True)
    jr = np.exp(-d2.T / 0.005)
    jr /= jr.sum(1, keepdims=True)
    return {"v_template": v_template,
            "shapedirs": rng.standard_normal((V, 3, 10)) * 0.01,
            "posedirs": rng.standard_normal((V, 3, 9 * (J - 1))) * 0.001,
            "j_regressor": jr, "weights": w, "parents": parents,
            "faces": faces}


def reference_body(arrays: dict, markers, device) -> dict:
    """The arrays as the reference reads them, on ``device``."""
    import torch

    from bench_port.reference.geometry import face_incidence

    body = {k: torch.as_tensor(np.asarray(arrays[k], np.float32),
                               device=device)
            for k in ("v_template", "shapedirs", "posedirs", "j_regressor",
                      "weights")}
    faces = np.asarray(arrays["faces"], np.int64)
    V = arrays["v_template"].shape[0]
    body.update(
        parents=np.asarray(arrays["parents"]),
        faces_t=torch.as_tensor(faces, device=device),
        incident=torch.as_tensor(face_incidence(faces, V), device=device),
        markers=torch.as_tensor(np.minimum(np.asarray(markers), V - 1),
                                dtype=torch.long, device=device))
    return body
