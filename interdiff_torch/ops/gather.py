"""Batched row gather for PointNet++ grouping: kernel K5.

Counterpart of `interdiff_tpu/ops/pallas_gather.py` (`gather_rows`,
`gather_rows_pallas`): ``out[b, k, :] = data[b, idx[b, k], :]`` for data
[B, N, C] and idx [B, K].  On a CUDA tensor inside the kernel's gate
(float32, C <= ``MAX_C``) the wrapper launches the hand-written kernel
`csrc/gather.cu`, which replaces the Pallas kernel `gather_rows_pallas`; on
a CPU tensor it runs ``gather_rows_plain``, PyTorch indexing.  There is no
fallback between the two: a CUDA tensor launches the kernel or raises.
`ops/pointcloud.py::query_and_group` sends narrow float32 data through
``gather_rows``, as the JAX package does; wider data (stage 2 of the
encoder, 99 channels) is indexed directly there.

The kernel is a copy, not the masked sum the TPU needed, so it keeps -0.0
where the Pallas kernel gives +0.0; otherwise the two agree value for value,
and the kernel equals the plain version bit for bit.  An index outside
[0, N): the kernel writes a zero row (what the Pallas masked sum gives) and
reads nothing out of bounds; the plain version, on the CPU, raises
`IndexError`.  Indices in range are the contract.

Gradient: as in `_gather_rows_bwd`, the cotangent is scatter-added at
``idx`` in plain PyTorch (the JAX package has no backward kernel either).  On
the card that sum uses atomic adds, so rows hit more than once are summed in
an order that changes from run to run.

Bound: bytes (idx, the output, one pass over data); microseconds at the
main-path shape, the order of a launch.  The library is built with nvcc at
first use (`ops/_build.py`).
"""

from __future__ import annotations

import ctypes

import torch

from interdiff_torch.ops import _build

MAX_C = 8  # widest row the kernel takes, the cap of the JAX package

# launches of the CUDA kernel in this process; a run resets it to 0 and
# reads it back to show that the path went through the kernel
launches = 0

_lib = None


def build() -> str:
    """Compile `csrc/gather.cu` into a shared library (once per source hash)
    and return its path."""
    return _build.build("gather")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gather_rows_f32.argtypes = (
            [ptr] * 3 + [i32] * 3 + [ctypes.c_longlong, i32, ptr])
        lib.gather_rows_f32.restype = i32
        _lib = lib
    return _lib


def in_gate(data: torch.Tensor) -> bool:
    """True where `query_and_group` routes ``data`` [B, N, C] to K5: the
    gate of the JAX package's `gather_rows` (float32 and C <= 8)."""
    return data.dtype == torch.float32 and data.shape[-1] <= MAX_C


def gather_rows_plain(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: data [B, N, C], idx [B, K] int
    -> [B, K, C] by indexing."""
    batch = torch.arange(data.shape[0], device=data.device)[:, None]
    return data[batch, idx.to(torch.int64)]


def gather_rows_cuda(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch K5 on the current stream: the same function as
    ``gather_rows_plain``, on contiguous CUDA tensors inside the gate."""
    global launches
    if data.ndim != 3 or idx.ndim != 2 or idx.shape[0] != data.shape[0]:
        raise ValueError(f"shapes do not match: data {tuple(data.shape)}, "
                         f"idx {tuple(idx.shape)}")
    if not data.is_cuda or not data.is_contiguous() or not in_gate(data):
        raise ValueError(f"data must be a contiguous float32 CUDA tensor "
                         f"with at most {MAX_C} channels, got "
                         f"{tuple(data.shape)} {data.dtype} on {data.device}")
    if idx.device != data.device or not idx.is_contiguous() \
            or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be a contiguous int32 or int64 tensor on "
                         f"{data.device}, got {idx.dtype} on {idx.device}")
    B, N, C = data.shape
    K = idx.shape[1]
    out = torch.empty((B, K, C), dtype=torch.float32, device=data.device)
    if B == 0 or K == 0:
        return out
    lib = _library()
    with torch.cuda.device(data.device):
        err = lib.gather_rows_f32(
            data.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, C, K,
            int(idx.dtype == torch.int64),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows_f32 launch failed: CUDA error {err}")
    launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` with the VJP of `_gather_rows_bwd`: the forward is
    the kernel (CUDA) or the plain version (CPU), the backward a scatter-add
    of the cotangent at ``idx``; ``idx`` gets no gradient."""

    @staticmethod
    def forward(ctx, data, idx):
        ctx.save_for_backward(idx)
        ctx.rows = data.shape[1]
        if data.is_cuda:
            return gather_rows_cuda(data.contiguous(), idx.contiguous())
        if data.device.type != "cpu":
            raise ValueError(f"no K5 path for device {data.device}")
        return gather_rows_plain(data, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        B, K, C = g.shape
        g_data = g.new_zeros((B, ctx.rows, C))
        g_data.scatter_add_(
            1, idx.to(torch.int64)[..., None].expand(B, K, C), g)
        return g_data, None


def gather_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather through K5: data [B, N, C <= 8] float32, idx
    [B, K] int in [0, N) -> [B, K, C], differentiable in ``data``."""
    return _GatherRows.apply(data, idx)
