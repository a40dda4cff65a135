"""Builds the package's CUDA sources into shared libraries with nvcc.

A source `csrc/<name>.cu` with a plain C interface becomes
``_build/<name>_<hash of the source>.so`` at first use and is rebuilt when
the source changes.  The wrappers load it with `ctypes`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PACKAGE, "_build")


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` for sm_90a (once per source hash) and return
    the library's path."""
    source = os.path.join(_PACKAGE, "csrc", f"{name}.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"{name}_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
             source], check=True)
        os.replace(tmp, so_path)
    return so_path
