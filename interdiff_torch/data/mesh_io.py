"""Minimal mesh I/O and surface sampling, host numpy: the port's copy of
`interdiff_tpu/data/mesh_io.py`.

Replaces the reference's `psbody.mesh.Mesh` / `trimesh` usage
(`data/prepare_behave.py:76,92-94`, `eval_smpl_short.py:317`).  Supports
OBJ (ascii) and PLY (ascii and binary little-endian) triangle meshes, and
area-weighted surface sampling with face normals (the `trimesh.sample`
contract used for the 2048 object points).  Vertices are float64.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


@dataclass
class Mesh:
    vertices: np.ndarray  # [V, 3] float64
    faces: np.ndarray  # [F, 3] int32

    @property
    def face_normals(self) -> np.ndarray:
        tri = self.vertices[self.faces]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)

    @property
    def face_areas(self) -> np.ndarray:
        tri = self.vertices[self.faces]
        n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        return 0.5 * np.linalg.norm(n, axis=1)


def load_obj(path: str | Path) -> Mesh:
    verts, faces = [], []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:]]
                idx = [int(i) - 1 if int(i) > 0 else len(verts) + int(i)
                       for i in idx]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(np.asarray(verts, np.float64), np.asarray(faces, np.int32))


def load_ply(path: str | Path) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode("ascii", errors="ignore").splitlines()
    fmt = "ascii"
    nv = nf = 0
    v_props = []
    reading = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            reading = t[1]
            if t[1] == "vertex":
                nv = int(t[2])
            elif t[1] == "face":
                nf = int(t[2])
        elif t[0] == "property" and reading == "vertex":
            v_props.append((t[1], t[2]))

    if fmt == "ascii":
        body = data[header_end:].decode("ascii").split()
        stride = len(v_props)
        vals = np.asarray(body[: nv * stride], dtype=np.float64)
        verts = vals.reshape(nv, stride)[:, :3]
        faces = []
        pos = nv * stride
        for _ in range(nf):
            cnt = int(body[pos])
            idx = [int(x) for x in body[pos + 1 : pos + 1 + cnt]]
            pos += 1 + cnt
            for k in range(1, cnt - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
        return Mesh(verts, np.asarray(faces, np.int32))

    # binary little endian
    sizes = {"float": 4, "float32": 4, "double": 8, "float64": 8,
             "uchar": 1, "uint8": 1, "char": 1, "int8": 1,
             "short": 2, "ushort": 2, "int": 4, "uint": 4,
             "int32": 4, "uint32": 4}
    np_types = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "float64": "<f8"}
    stride = sum(sizes[t] for t, _ in v_props)
    off = header_end
    raw = np.frombuffer(data, dtype=np.uint8,
                        count=nv * stride, offset=off).reshape(nv, stride)
    cols = []
    c = 0
    for t, name in v_props:
        if name in ("x", "y", "z"):
            cols.append(raw[:, c : c + sizes[t]].copy().view(
                np_types[t]).reshape(nv))
        c += sizes[t]
    verts = np.stack(cols, axis=1).astype(np.float64)
    off += nv * stride
    faces = []
    pos = off
    while len(faces) < nf and pos < len(data):
        cnt = data[pos]
        idx = struct.unpack_from(f"<{cnt}i", data, pos + 1)
        pos += 1 + 4 * cnt
        for k in range(1, cnt - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])
    return Mesh(verts, np.asarray(faces, np.int32))


def load_mesh(path: str | Path) -> Mesh:
    path = Path(path)
    if path.suffix.lower() == ".obj":
        return load_obj(path)
    if path.suffix.lower() == ".ply":
        return load_ply(path)
    raise ValueError(f"unsupported mesh format: {path}")


def sample_surface(mesh: Mesh, n: int, *, rng: Optional[np.random.Generator]
                   = None) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted surface sampling -> (points [n,3], face idx [n])."""
    rng = rng or np.random.default_rng(233)
    areas = mesh.face_areas
    probs = areas / areas.sum()
    fidx = rng.choice(len(probs), size=n, p=probs)
    tri = mesh.vertices[mesh.faces[fidx]]
    r1 = np.sqrt(rng.random(n))[:, None]
    r2 = rng.random(n)[:, None]
    pts = (1 - r1) * tri[:, 0] + r1 * (1 - r2) * tri[:, 1] + r1 * r2 * tri[:, 2]
    return pts, fidx
