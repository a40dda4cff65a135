"""Fused ball query + group for PointNet++ stage 1: kernel K1.

Counterpart of `interdiff_tpu/ops/pallas_group.py` (`fused_query_group`,
`pairwise_sqdist_t`).  On a CUDA tensor the wrapper launches the hand-written
kernel `csrc/ball_group.cu`, which replaces the Pallas kernel
`_select_sum_pallas` and the row fix-ups of `_fused_impl`; on a CPU tensor it
runs ``group_plain``, the plain PyTorch version of the same function.  There
is no fallback between the two: a CUDA tensor launches the kernel or raises.

Gradient (`_fqg_bwd`): the JAX package has no backward kernel; its VJP is
that of the reference grouping.  Here ``fused_query_group`` is a
`torch.autograd.Function` whose backward replays `query_and_group` on the
forward's own ``d2t`` (a recomputed distance could flip a borderline
in-radius selection and scatter the cotangent to other neighbours), which
gathers through kernel K5 and scatter-adds the cotangent; ``d2t`` gets none.
Stage 1 of the encoder groups raw data, so a train step never builds this
backward: it exists for gradients with respect to the cloud.

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
from typing import Optional

import torch

from interdiff_torch.ops import _build
from interdiff_torch.ops.gather import gather_rows_plain
from interdiff_torch.ops.pointcloud import (
    pairwise_sqdist,
    query_and_group,
    radius_sq,
)

MAX_C = 8  # widest data row the kernel takes (xyz + up to 5 features)

# launches of the CUDA kernel in this process; a run resets it to 0 and
# reads it back to show that the path went through the kernel
launches = 0

_lib = None


def pairwise_sqdist_t(xyz: torch.Tensor, new_xyz: torch.Tensor
                      ) -> torch.Tensor:
    """Transposed squared distances [B, N, M] (candidates on axis 1, the
    layout the kernel streams); one matrix serves every radius scale."""
    return pairwise_sqdist(xyz, new_xyz)


def build() -> str:
    """Compile `csrc/ball_group.cu` into a shared library (once per source
    hash) and return its path."""
    return _build.build("ball_group")


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
    distances, with the kernel's arguments and the plain gather (no kernel
    runs in it).

    d2t [B, N, M], data [B, N, C] (xyz first), new_xyz [B, M, 3] ->
    [B, M, nsample, C].
    """
    features = data[..., 3:] if data.shape[-1] > 3 else None
    return query_and_group(data[..., :3], new_xyz, features, radius, nsample,
                           d2=d2t.transpose(1, 2), gather=gather_rows_plain)


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


class _FusedQueryGroup(torch.autograd.Function):
    """K1 (CUDA) or its plain version (CPU) forward; backward by replay of
    `query_and_group` on the saved ``d2t``."""

    @staticmethod
    def forward(ctx, xyz, new_xyz, features, d2t, radius, nsample):
        ctx.save_for_backward(xyz, new_xyz, features, d2t)
        ctx.radius, ctx.nsample = radius, nsample
        data = xyz if features is None else torch.cat([xyz, features], dim=-1)
        if d2t.is_cuda:
            return group_cuda(d2t.contiguous(), data.contiguous(),
                              new_xyz.contiguous(), radius, nsample)
        if d2t.device.type != "cpu":
            raise ValueError(f"no K1 path for device {d2t.device}")
        return group_plain(d2t, data, new_xyz, radius, nsample)

    @staticmethod
    def backward(ctx, g):
        xyz, new_xyz, features, d2t = ctx.saved_tensors
        wanted = [need and t is not None for need, t in zip(
            ctx.needs_input_grad[:3], (xyz, new_xyz, features))]
        if not any(wanted):  # only d2t asked: the selection is constant
            return (None,) * 6
        with torch.enable_grad():
            inputs = [None if t is None else t.detach().requires_grad_(w)
                      for t, w in zip((xyz, new_xyz, features), wanted)]
            replay = query_and_group(*inputs, ctx.radius, ctx.nsample,
                                     d2=d2t.detach().transpose(1, 2))
            grads = iter(torch.autograd.grad(
                replay, [t for t, w in zip(inputs, wanted) if w], g))
        return tuple(next(grads) if w else None for w in wanted) \
            + (None, None, None)


def fused_query_group(xyz: torch.Tensor, new_xyz: torch.Tensor,
                      features: Optional[torch.Tensor], radius: float,
                      nsample: int,
                      d2t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`QueryAndGroup` through K1: xyz [B, N, 3], new_xyz [B, M, 3],
    features [B, N, C] | None, ``d2t`` optional shared
    :func:`pairwise_sqdist_t` -> [B, M, nsample, 3 + C], bit-identical to
    `ops/pointcloud.query_and_group` on the same distances, differentiable
    in xyz, new_xyz and features."""
    if d2t is None:
        d2t = pairwise_sqdist_t(xyz, new_xyz)
    return _FusedQueryGroup.apply(xyz, new_xyz, features, d2t, radius,
                                  nsample)
