"""ctypes binding of the host C++ signed-distance engine
(`native/mesh_distance.cpp`, shared with the JAX package and never edited
here): a median-split AABB tree over the faces and the angle-weighted
pseudonormal sign, the BVH counterpart of `ops/mesh_distance.py`'s brute
force.  The port's own copy of `interdiff_tpu/utils/native.py`.

The library is compiled at first use with ``g++ -O3 -fPIC -std=c++17
-shared`` into ``interdiff_torch/_build/`` (keyed by the hash of the source,
so an edited source builds anew), never into ``native/``.  A failed build
raises; nothing falls back to another engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "mesh_distance.cpp")
_BUILD_DIR = os.path.join(_ROOT, "interdiff_torch", "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_lib: Optional[ctypes.CDLL] = None

_FLOATS = ctypes.POINTER(ctypes.c_float)
_INTS = ctypes.POINTER(ctypes.c_int)


def library_path() -> str:
    """Where the built engine lies: the name carries the hash of the source
    and the compiler's flags."""
    sha = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        sha.update(f.read())
    sha.update("\0".join(CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR,
                        f"libmesh_distance_{sha.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the engine once per hash of its source; raises with the
    compiler's output when g++ is missing or fails."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        done = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ cannot build {SOURCE}: {e}") from e
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{done.stdout}"
                           f"{done.stderr}")
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.sd_build.restype = ctypes.c_void_p
        lib.sd_build.argtypes = [_FLOATS, ctypes.c_int, _INTS, ctypes.c_int]
        lib.sd_query.restype = None
        lib.sd_query.argtypes = [ctypes.c_void_p, _FLOATS, ctypes.c_int,
                                 _FLOATS, _INTS, _FLOATS]
        lib.sd_free.restype = None
        lib.sd_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def native_available() -> bool:
    """Whether the engine builds and loads here (it is built to find out)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


class SignedDistanceMesh:
    """BVH-accelerated signed-distance queries against one fixed mesh
    (float32 vertices, int32 faces, as the engine takes them)."""

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        self._lib = _load()
        self._verts = np.ascontiguousarray(verts, dtype=np.float32)
        self._faces = np.ascontiguousarray(faces, dtype=np.int32)
        self._handle = self._lib.sd_build(
            self._verts.ctypes.data_as(_FLOATS), len(self._verts),
            self._faces.ctypes.data_as(_INTS), len(self._faces))

    def query(self, points: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """points [N, 3] -> (signed distance [N] float32, negative inside;
        closest face [N] int32; closest point [N, 3] float32)."""
        pts = np.ascontiguousarray(points, dtype=np.float32)
        n = len(pts)
        dist = np.empty(n, dtype=np.float32)
        face = np.empty(n, dtype=np.int32)
        cp = np.empty((n, 3), dtype=np.float32)
        self._lib.sd_query(self._handle, pts.ctypes.data_as(_FLOATS), n,
                           dist.ctypes.data_as(_FLOATS),
                           face.ctypes.data_as(_INTS),
                           cp.ctypes.data_as(_FLOATS))
        return dist, face, cp

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.sd_free(handle)
            self._handle = None


def signed_distance(points: np.ndarray, verts: np.ndarray,
                    faces: np.ndarray, *, engine: str,
                    device=None) -> np.ndarray:
    """One query, signed distances [N] float32, through the named engine:
    ``"native"`` (this BVH, on the host) or ``"torch"``
    (`ops/mesh_distance.py` on ``resolve_device(device)``, CUDA unless
    named).  No fallback: an engine that cannot run raises."""
    if engine == "native":
        return SignedDistanceMesh(verts, faces).query(points)[0]
    if engine == "torch":
        from interdiff_torch.ops.mesh_distance import signed_distance_to_mesh

        return signed_distance_to_mesh(points, verts, faces,
                                       device=device)[0].cpu().numpy()
    raise ValueError(f"unknown engine {engine!r}: 'native' or 'torch'")
