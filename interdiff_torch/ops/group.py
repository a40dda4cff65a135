"""Fused ball query + group for PointNet++ stage 1: kernel K1.

Counterpart of `interdiff_tpu/ops/pallas_group.py` (`fused_query_group`,
`pairwise_sqdist_t`).  On a CUDA tensor the wrapper launches the hand-written
kernel `csrc/ball_group.cu`, which replaces the Pallas kernel
`_select_sum_pallas` and the row fix-ups of `_fused_impl`; on a CPU tensor it
runs ``group_plain``, the plain PyTorch version of the same function.  There
is no fallback between the two: a CUDA tensor launches the kernel or raises.

Bound: bytes.  The kernel reads the transposed distances d2t [B, N, M] once
(268 MB per radius scale at the main-path shape B=32, N=2048, M=1024, plus
8 and 16 MB of output: about 83 and 85 us at 3.35 TB/s; less where a query
fills its slots early, since its walk stops at the last slot).  It reads
d2t coalesced, one thread per query walking the candidates in order, and
keeps no [N, M] intermediate.

The library is built with nvcc at first use from the source in this
package, into ``_build/`` beside it, and rebuilt when the source changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import torch

from interdiff_torch.ops.pointcloud import (
    pairwise_sqdist,
    query_and_group,
    radius_sq,
)

MAX_C = 8  # widest data row the kernel takes (xyz + up to 5 features)

# launches of the CUDA kernel in this process; a run resets it to 0 and
# reads it back to show that the path went through the kernel
launches = 0

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(os.path.dirname(_HERE), "csrc", "ball_group.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_lib = None


def pairwise_sqdist_t(xyz: torch.Tensor, new_xyz: torch.Tensor
                      ) -> torch.Tensor:
    """Transposed squared distances [B, N, M] (candidates on axis 1, the
    layout the kernel streams); one matrix serves every radius scale."""
    return pairwise_sqdist(xyz, new_xyz)


def _nvcc() -> str:
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the K1 kernel cannot be built")


def build() -> str:
    """Compile `csrc/ball_group.cu` into a shared library (once per source
    hash) and return its path."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"ball_group_{digest}.so")
    if not os.path.exists(so_path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
             "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
             _SOURCE], check=True)
        os.replace(tmp, so_path)
    return so_path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.ball_group_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        lib.ball_group_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def group_plain(d2t: torch.Tensor, data: torch.Tensor, new_xyz: torch.Tensor,
                radius: float, nsample: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: `query_and_group` on the same
    distances, with the kernel's arguments.

    d2t [B, N, M], data [B, N, C] (xyz first), new_xyz [B, M, 3] ->
    [B, M, nsample, C].
    """
    features = data[..., 3:] if data.shape[-1] > 3 else None
    return query_and_group(data[..., :3], new_xyz, features, radius, nsample,
                           d2=d2t.transpose(1, 2))


def group_cuda(d2t: torch.Tensor, data: torch.Tensor, new_xyz: torch.Tensor,
               radius: float, nsample: int) -> torch.Tensor:
    """Launch K1 on the current stream: the same function as
    ``group_plain``, on contiguous float32 CUDA tensors."""
    global launches
    B, N, M = d2t.shape
    C = data.shape[-1]
    for name, t in (("d2t", d2t), ("data", data), ("new_xyz", new_xyz)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}")
        if t.device != d2t.device:
            raise ValueError(f"{name} is on {t.device}, d2t on {d2t.device}")
    if data.shape[:2] != (B, N) or new_xyz.shape != (B, M, 3):
        raise ValueError(f"shapes do not match: d2t {tuple(d2t.shape)}, "
                         f"data {tuple(data.shape)}, "
                         f"new_xyz {tuple(new_xyz.shape)}")
    if not 3 <= C <= MAX_C or N < 1 or nsample < 1 or B > 65535:
        raise ValueError(f"unsupported sizes B={B} N={N} C={C} S={nsample}")
    lib = _library()
    out = torch.empty((B, M, nsample, C), dtype=torch.float32,
                      device=d2t.device)
    with torch.cuda.device(d2t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ball_group_f32(
            d2t.data_ptr(), data.data_ptr(), new_xyz.data_ptr(),
            out.data_ptr(), B, N, M, C, nsample, radius_sq(radius), stream)
    if err != 0:
        raise RuntimeError(f"ball_group_f32 launch failed: CUDA error {err}")
    launches += 1
    return out


def fused_query_group(xyz: torch.Tensor, new_xyz: torch.Tensor,
                      features: Optional[torch.Tensor], radius: float,
                      nsample: int,
                      d2t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`QueryAndGroup` through K1: xyz [B, N, 3], new_xyz [B, M, 3],
    features [B, N, C] | None, ``d2t`` optional shared
    :func:`pairwise_sqdist_t` -> [B, M, nsample, 3 + C], bit-identical to
    `ops/pointcloud.query_and_group` on the same distances."""
    data = xyz if features is None else torch.cat([xyz, features], dim=-1)
    if d2t is None:
        d2t = pairwise_sqdist_t(xyz, new_xyz)
    if d2t.is_cuda:
        return group_cuda(d2t, data.contiguous(), new_xyz.contiguous(),
                          radius, nsample)
    if d2t.device.type != "cpu":
        raise ValueError(f"no K1 path for device {d2t.device}")
    return group_plain(d2t, data, new_xyz, radius, nsample)
