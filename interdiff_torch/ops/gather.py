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
main-path shape, the order of a launch, so the host path counts as much as
the copy: the wrapper checks with the cheap conditions first and launches
through `ops/_build.py::launch` (no stream object, no device guard on the
current device).  The library is built with nvcc at first use.
"""

from __future__ import annotations

import torch

from interdiff_torch.ops import _build

MAX_C = 8  # widest row the kernel takes, the cap of the JAX package

# launches of the CUDA kernel in this process; a run resets it to 0 and
# reads it back to show that the path went through the kernel
launches = 0

SOURCE = "gather"  # csrc/gather.cu
# parameter kinds of its C entries (see `ops/_build.py`)
C_ENTRIES = {"gather_rows_f32": ("ptr",) * 3 + ("int",) * 3
             + ("i64", "int", "ptr")}

_lib = None


def build() -> str:
    """Compile `csrc/gather.cu` into a shared library (once per source hash)
    and return its path."""
    return _build.build(SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load(SOURCE, C_ENTRIES)
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
    if not (data.is_cuda and data.dtype == torch.float32 and data.ndim == 3
            and data.shape[2] <= MAX_C and data.is_contiguous()):
        raise ValueError(f"data must be a contiguous float32 CUDA tensor "
                         f"[B, N, C <= {MAX_C}], got {tuple(data.shape)} "
                         f"{data.dtype} on {data.device}")
    if not (idx.ndim == 2 and idx.shape[0] == data.shape[0]
            and idx.get_device() == data.get_device()
            and idx.dtype in (torch.int64, torch.int32)
            and idx.is_contiguous()):
        raise ValueError(f"idx must be a contiguous int32 or int64 tensor "
                         f"[B, K] on {data.device}, got {tuple(idx.shape)} "
                         f"{idx.dtype} on {idx.device}")
    B, N, C = data.shape
    K = idx.shape[1]
    out = data.new_empty((B, K, C))
    if B == 0 or K == 0:
        return out
    _build.launch(_library().gather_rows_f32, data, data.data_ptr(),
                  idx.data_ptr(), out.data_ptr(), B, N, C, K,
                  int(idx.dtype == torch.int64))
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
