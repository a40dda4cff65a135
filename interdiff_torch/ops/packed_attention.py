"""Multi-head self-attention read from a packed QKV product: kernel K7.

``packed_attention(qkv, num_heads, mask)`` takes the output of one packed
in-projection, qkv [B, T, 3D] with q, k and v side by side (the column
layout of `TorchMHA.in_proj_kernel`, head h at columns h*hd of each), and
returns what `ops/attention.py::multi_head_attention` returns on its three
slices: per head softmax(q k^T / sqrt(hd) + mask) v, heads concatenated,
[B, T, D].  On a CUDA tensor the wrapper launches the hand-written kernel
`csrc/attention.cu`; on a CPU tensor it runs ``packed_attention_plain``.
There is no fallback between the two: a CUDA tensor launches the kernel
or raises.

The kernel replaces no Pallas kernel (the JAX package leaves dense
attention to XLA).  It serves MDM's encoder layers
(`models/layers.py::PackedEncoderLayer`), where the library route moved
each of q, k, v and the output through a copy to and from the [B, H, T,
hd] layout and wrote [B, H, T, T] scores for passes of their own.  Bound:
operations, 4 B H T^2 hd FLOPs in float32 FFMA (76 us at MDM's guided
shape and 67 TFLOP/s; the kernel's note has its design).  It sums in
another order than the library's and keeps an online softmax, so it agrees
with the plain version to a few float32 roundings, not bit for bit.  It
has no backward: the layers take it without a gradient only.  The library
is built with nvcc at first use.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from interdiff_torch.ops import _build

HEAD_DIM = 128  # the head size the kernel is built for (MDM's)

# launches of the CUDA kernel in this process; a run resets it to 0 and
# reads it back to show that the path went through the kernel
launches = 0

SOURCE = "attention"  # csrc/attention.cu
# parameter kinds of its C entries (see `ops/_build.py`)
C_ENTRIES = {"packed_attention_f32": ("ptr",) * 3 + ("int",) * 4
             + ("f32", "ptr")}

_lib = None


def build() -> str:
    """Compile `csrc/attention.cu` into a shared library (once per source
    hash) and return its path."""
    return _build.build(SOURCE)


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load(SOURCE, C_ENTRIES)
    return _lib


def packed_attention_plain(qkv: torch.Tensor, num_heads: int,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: qkv [B, T, 3D] -> [B, T, D]."""
    B, T, D3 = qkv.shape
    hd = D3 // 3 // num_heads
    q, k, v = qkv.reshape(B, T, 3, num_heads, hd).unbind(2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D3 // 3)


def packed_attention_cuda(qkv: torch.Tensor, num_heads: int,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Launch K7 on the current stream: the same function as
    ``packed_attention_plain``, on a contiguous float32 CUDA tensor, with
    no gradient."""
    global launches
    if not (qkv.is_cuda and qkv.dtype == torch.float32 and qkv.ndim == 3
            and qkv.shape[2] % 3 == 0 and qkv.is_contiguous()
            and qkv.shape[2] == 3 * num_heads * HEAD_DIM
            and qkv.data_ptr() % 16 == 0):
        raise ValueError(f"qkv must be a contiguous, 16-byte aligned float32 "
                         f"CUDA tensor [B, T, 3 H {HEAD_DIM}], got "
                         f"{tuple(qkv.shape)} {qkv.dtype} on {qkv.device} "
                         f"for {num_heads} heads")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise ValueError("K7 has no backward: call it without a gradient")
    B, T, D3 = qkv.shape
    if mask is not None and not (
            mask.shape == (T, T) and mask.dtype == torch.float32
            and mask.get_device() == qkv.get_device()
            and mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous float32 [{T}, {T}] "
                         f"tensor on {qkv.device}, got {tuple(mask.shape)} "
                         f"{mask.dtype} on {mask.device}")
    out = qkv.new_empty((B, T, D3 // 3))
    _build.launch(_library().packed_attention_f32, qkv, qkv.data_ptr(),
                  0 if mask is None else mask.data_ptr(), out.data_ptr(), B,
                  T, num_heads, HEAD_DIM, 1.0 / math.sqrt(HEAD_DIM))
    launches += 1
    return out


def packed_attention(qkv: torch.Tensor, num_heads: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention of qkv [B, T, 3D] (q | k | v) under the additive
    ``mask`` [T, T] (none: unmasked) -> [B, T, D]: K7 on CUDA, the plain
    version on the CPU."""
    if qkv.is_cuda:
        return packed_attention_cuda(qkv, num_heads, mask)
    if qkv.device.type != "cpu":
        raise ValueError(f"no K7 path for device {qkv.device}")
    return packed_attention_plain(qkv, num_heads, mask)
