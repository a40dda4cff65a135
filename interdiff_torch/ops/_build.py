"""Builds the package's CUDA sources into shared libraries with nvcc, binds
their C entries with `ctypes` and launches them.

A source `csrc/<name>.cu` with a plain C interface becomes
``_build/<name>_<hash>.so`` at first use, the hash taken over the source,
the headers `csrc/*.cuh` and nvcc's flags (``-D`` definitions included), so
a change of any of them builds anew; ptxas's report of each kernel's
registers, shared memory and spills is kept beside it (``<library>.log``,
read by :func:`ptxas_report`), and a library without its report counts as
not built.

Each wrapper module declares its C entries in a table ``C_ENTRIES``: the
kind of every parameter, in order (``ptr``, ``int``, ``i64``, ``f32``,
``int*``; the stream is the last ``ptr``).  :func:`load` sets the `ctypes`
argument types from that table, and `tests/test_torch_launch_abi.py` holds
the table against the ``extern "C"`` signatures of the source without
loading the library: a pointer declared as an int would be cut silently.

:func:`launch` is the one launch path of every wrapper: it calls the entry
on the current stream of the tensor's device and raises on a nonzero
return.  It neither synchronises nor allocates, so every launch can be
captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, List, Sequence

import torch

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(_PACKAGE, "_build")

KINDS = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
         "i64": ctypes.c_longlong, "f32": ctypes.c_float,
         "int*": ctypes.POINTER(ctypes.c_int)}


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_path(name: str) -> str:
    return os.path.join(_PACKAGE, "csrc", f"{name}.cu")


def nvcc_flags(defines: Sequence[str] = ()) -> List[str]:
    """nvcc's flags for a library, ``-D<define>`` for each of ``defines``."""
    return (["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
            + [f"-D{d}" for d in defines])


def library_path(name: str, defines: Sequence[str] = ()) -> str:
    """Where `csrc/<name>.cu` built with ``defines`` lies: the name carries
    the hash of the source, the shared headers and nvcc's flags."""
    sha = hashlib.sha256()
    for path in [source_path(name)] + sorted(
            glob.glob(os.path.join(_PACKAGE, "csrc", "*.cuh"))):
        with open(path, "rb") as f:
            sha.update(f.read())
    sha.update("\0".join(nvcc_flags(defines)).encode())
    return os.path.join(_BUILD_DIR, f"{name}_{sha.hexdigest()[:16]}.so")


def build(name: str, defines: Sequence[str] = ()) -> str:
    """Compile `csrc/<name>.cu` for sm_90a (once per hash of the source, the
    shared headers and the flags) and return the library's path."""
    so_path = library_path(name, defines)
    if not (os.path.exists(so_path) and os.path.exists(f"{so_path}.log")):
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        source = source_path(name)
        done = subprocess.run([_nvcc()] + nvcc_flags(defines)
                              + ["-o", tmp, source],
                              capture_output=True, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{done.stdout}"
                               f"{done.stderr}")
        with open(f"{so_path}.log", "w") as f:
            f.write(done.stdout + done.stderr)
        os.replace(tmp, so_path)
    return so_path


def ptxas_report(name: str, defines: Sequence[str] = ()) -> List[Dict]:
    """Registers, spill bytes and shared memory of each kernel of
    `csrc/<name>.cu` (built with ``defines``) from ptxas's report."""
    with open(f"{build(name, defines)}.log") as f:
        return parse_ptxas(f.read())


def parse_ptxas(text: str) -> List[Dict]:
    """[{kernel, registers, spill_stores, spill_loads, smem_bytes}] from
    the output of ``nvcc -Xptxas -v``."""
    out, entry = [], None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = {"kernel": m.group(1)}
            out.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["spill_stores"], entry["spill_loads"] = map(int,
                                                               m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entry["smem_bytes"] = int(m.group(1)) if m else 0
    return [e for e in out if "registers" in e]


def load(name: str, entries: Dict[str, Sequence[str]],
         defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` (with ``defines``), load it and set each
    entry's argument types from ``entries`` (name -> parameter kinds); every
    entry returns int."""
    lib = ctypes.CDLL(build(name, defines))
    for fn_name, kinds in entries.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = [KINDS[k] for k in kinds]
        fn.restype = ctypes.c_int
    return lib


def launch(fn, like: torch.Tensor, *args) -> None:
    """``fn(*args, stream)`` on the current stream of ``like``'s CUDA
    device; a device guard is entered only when that device is not the
    current one.  Raises on a nonzero return (the entry's
    ``cudaGetLastError()``): there is no fallback."""
    index = like.get_device()
    if index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
