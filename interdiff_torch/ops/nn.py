"""Brute-force nearest-neighbour sweeps: kernels K2, K3 and K4.

Counterpart of `interdiff_tpu/ops/pallas_nn.py`.  On CUDA tensors the
wrappers launch the hand-written kernels of `csrc/nn.cu`:

* ``nearest_neighbor_cuda`` (K4) replaces `nearest_neighbor_pallas`;
* ``signed_nearest_cuda`` (K3, forward) replaces `signed_nearest_pallas`;
* ``signed_nearest_pruned_cuda`` (K2) replaces
  `signed_nearest_pruned_pallas`.

K2 and K3 run one sweep body (`signed_sweep_kernel`): K3 walks every
segment, K2 only those its prologue flags, so the two agree inside delta by
construction.  K4 (`nearest_kernel`) splits a frame's surface over the
threads of a block instead, which keeps every lane busy at the 67 queries a
frame of the correction's marker sweep.

Beside each stands its plain PyTorch version (``*_plain``), which repeats
the kernel's arithmetic step by step, so that the two agree bit for bit on
one device; `ops/signed_distance.py` routes a CPU tensor to the plain
version and a CUDA tensor to the kernel, with no fallback between them.

Gradients (`_nn_diff_bwd`, `_snn_diff_bwd`): ``nearest_neighbor_diff`` (K4)
and ``signed_nearest_diff`` (K3) are `torch.autograd.Function`s whose forward
is the kernel on the card and the plain version on the CPU, and whose
backward is plain PyTorch on both, as the JAX package's is plain XLA: with
``j*`` piecewise constant, ``sq = |a - b[j*]|^2`` and
``sdot = n[j*] . (a - b[j*])``, so the cotangents are gathers at ``j*`` for
``a`` and scatter-adds at ``j*`` for ``b`` and ``n`` (atomic adds on the
card: surface rows hit by several queries are summed in an order that changes
from run to run).  K2 carries no gradient, as in the JAX package.

All take a [B, N, 3] queries, b [B, M, 3] surface points and (signed
sweeps) n [B, M, 3] pseudonormals, and return per-query [B, N] tensors:
sq = |a - b[j*]|^2 clamped at 0, sdot = n[j*] . (a - b[j*]) and
idx = j* (int32), j* being the first index of the least score
``|b_j|^2 - 2 a.b_j``.

Pruning contract (`signed_nearest_pruned_*`): bit-equal to the full sweep
for every query whose nearest point is closer than ``delta``; exactly
``(delta^2, +1.0, 0)`` for every other query.  The kernel skips surface
segments of ``SEGMENT`` points that lie farther than ``delta`` from the
bounding box of the frame's queries; the plain version sweeps everything
and applies the same forcing.  K2's prologue computes the flags of
``segment_flags`` and the compacted list of ``segment_list_plain`` on the
device, so a call is three kernels behind one C entry and waits for nothing
on the host (it can be captured in a CUDA graph).

Bound: operations (8 float32 operations a pair: 3 products and 2 sums for
a.b, a product and a difference for the score, one comparison; the inputs
are read once).
The library is built with nvcc at first use (`ops/_build.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from interdiff_torch.ops import _build

SEGMENT = 256  # surface points per pruning segment: one tile of the kernel
# the flags keep every segment within delta * sqrt(_FLAG_SLACK) of the box:
# the box distance and the kernel's expanded |b|^2 - 2ab + |a|^2 round
# differently, and a query just inside delta must still find its segment
_FLAG_SLACK = 1.01
_PLAIN_SCORE_ELEMS = 1 << 26  # largest [frames, N, M] score block (256 MB)

# launches of each CUDA kernel in this process; a run resets them to 0 and
# reads them back to show that the path went through the kernels
launches = {"nearest_neighbor": 0, "signed_nearest": 0,
            "signed_nearest_pruned": 0}

SOURCE = "nn"  # csrc/nn.cu
# parameter kinds of its C entries (see `ops/_build.py`)
C_ENTRIES = {
    "nn_tile": (),
    "nn_nearest_f32": ("ptr",) * 4 + ("int",) * 3 + ("ptr",),
    "nn_signed_f32": ("ptr",) * 6 + ("int",) * 3 + ("ptr",),
    "nn_signed_pruned_f32": ("ptr",) * 10 + ("int",) * 3
    + ("f32", "f32", "ptr"),
}

_lib = None


def build() -> str:
    """Compile `csrc/nn.cu` into a shared library (once per source hash) and
    return its path."""
    return _build.build(SOURCE)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE, C_ENTRIES)
        if lib.nn_tile() != SEGMENT:
            raise RuntimeError(f"csrc/nn.cu tiles {lib.nn_tile()} points, "
                               f"the wrapper flags segments of {SEGMENT}")
        _lib = lib
    return _lib


def delta_squared(delta: float) -> float:
    """``float32(delta) * float32(delta)``, the threshold of the forcing."""
    d = np.float32(delta)
    return float(d * d)


# -- plain versions -----------------------------------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _sweep_plain(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sq [B, N], j* [B, N] int64): the kernels' score, first-occurrence
    argmin and clamp, in blocks of frames that bound the score tensor."""
    B, N, _ = a.shape
    M = b.shape[1]
    step = max(1, _PLAIN_SCORE_ELEMS // max(N * M, 1))
    sq, idx = [], []
    for s in range(0, B, step):
        ax, ay, az = (c.unsqueeze(-1) for c in a[s:s + step].unbind(-1))
        bx, by, bz = (c.unsqueeze(1) for c in b[s:s + step].unbind(-1))
        score = _dot3(bx, by, bz, bx, by, bz) \
            - 2.0 * _dot3(ax, ay, az, bx, by, bz)  # [step, N, M]
        # torch.min(dim) returns the first index of the least value
        best, j = score.min(dim=-1)
        a2 = _dot3(ax, ay, az, ax, ay, az).squeeze(-1)
        sq.append((best + a2).clamp(min=0.0))
        idx.append(j)
    return torch.cat(sq), torch.cat(idx)


def _sdot_plain(a, b, n, j):
    pick = j.unsqueeze(-1).expand(-1, -1, 3)
    bx, by, bz = b.gather(1, pick).unbind(-1)
    nx, ny, nz = n.gather(1, pick).unbind(-1)
    ax, ay, az = a.unbind(-1)
    return _dot3(ax, ay, az, nx, ny, nz) - _dot3(nx, ny, nz, bx, by, bz)


def nearest_neighbor_plain(a: torch.Tensor, b: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: (sq, idx)."""
    sq, j = _sweep_plain(a, b)
    return sq, j.to(torch.int32)


def signed_nearest_plain(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3: (sq, sdot, idx)."""
    sq, j = _sweep_plain(a, b)
    return sq, _sdot_plain(a, b, n, j), j.to(torch.int32)


def signed_nearest_pruned_plain(a: torch.Tensor, b: torch.Tensor,
                                n: torch.Tensor, delta: float = 0.25
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Plain version of K2: the full sweep, then ``(delta^2, +1, 0)`` for
    every query with sq >= delta^2."""
    sq, sdot, idx = signed_nearest_plain(a, b, n)
    d2 = delta_squared(delta)
    far = sq >= d2
    return (torch.where(far, d2, sq), torch.where(far, 1.0, sdot),
            torch.where(far, 0, idx))


def flag_threshold(delta: float) -> float:
    """``float32(delta^2 * 1.01)``: a segment is flagged when its least box
    distance lies below it (in ``segment_flags`` and in K2's prologue)."""
    return float(np.float32(delta_squared(delta) * _FLAG_SLACK))


def segment_flags(a: torch.Tensor, b: torch.Tensor, delta: float
                  ) -> torch.Tensor:
    """int32 [B, ceil(M / SEGMENT)]: 1 where some point of the segment lies
    within ``delta`` (plus the rounding slack) of the bounding box of the
    frame's queries, the squared box distance summed as ``(ex*ex + ey*ey) +
    ez*ez`` like K2's prologue.  O(M) a frame, plain PyTorch on the tensors'
    device."""
    B, M = b.shape[:2]
    qlo = a.amin(dim=1, keepdim=True)  # [B, 1, 3]
    qhi = a.amax(dim=1, keepdim=True)
    excess = torch.maximum(qlo - b, b - qhi).clamp(min=0.0)
    e2 = excess * excess
    boxd2 = (e2[..., 0] + e2[..., 1]) + e2[..., 2]  # [B, M]
    n_seg = -(-M // SEGMENT)
    boxd2 = torch.nn.functional.pad(boxd2, (0, n_seg * SEGMENT - M),
                                    value=float("inf"))
    seg_min = boxd2.reshape(B, n_seg, SEGMENT).amin(dim=-1)
    return (seg_min < flag_threshold(delta)).to(torch.int32)


def segment_list_plain(flags: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the compaction in K2's prologue: flags [B, n_seg]
    -> (count [B], ids [B, n_seg]) int32, the flagged segment ids of each
    frame in increasing order, then -1."""
    flagged = flags != 0
    count = flagged.sum(dim=1, dtype=torch.int32)
    order = torch.argsort((~flagged).to(torch.int8), dim=1, stable=True)
    pos = torch.arange(flags.shape[1], device=flags.device)
    ids = torch.where(pos < count[:, None], order, -1)
    return count, ids.to(torch.int32)


# -- CUDA wrappers ------------------------------------------------------------

def _check(a: torch.Tensor, *surfaces: torch.Tensor) -> Tuple[int, int, int]:
    """Raise on what the kernels do not take; returns (B, N, M)."""
    if a.ndim != 3 or a.shape[-1] != 3:
        raise ValueError(f"queries must be [B, N, 3], got {tuple(a.shape)}")
    B, N, _ = a.shape
    M = surfaces[0].shape[1] if surfaces[0].ndim == 3 else -1
    for name, t in zip("abn", (a,) + surfaces):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 CUDA "
                             f"tensor, got {t.dtype} on {t.device}"
                             f"{'' if t.is_contiguous() else ', strided'}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, a on {a.device}")
        if name != "a" and tuple(t.shape) != (B, M, 3):
            raise ValueError(f"{name} must be [{B}, M, 3] like the other "
                             f"surface tensor, got {tuple(t.shape)}")
    if B < 1 or N < 1 or M < 1 or -(-N // 128) > 65535:
        raise ValueError(f"unsupported sizes B={B} N={N} M={M}")
    return B, N, M


def nearest_neighbor_cuda(a: torch.Tensor, b: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on the current stream: (sq, idx) as
    ``nearest_neighbor_plain``, on contiguous float32 CUDA tensors."""
    B, N, M = _check(a, b)
    lib = _library()
    sq = torch.empty((B, N), dtype=torch.float32, device=a.device)
    idx = torch.empty((B, N), dtype=torch.int32, device=a.device)
    _build.launch(lib.nn_nearest_f32, a, a.data_ptr(), b.data_ptr(),
                  sq.data_ptr(), idx.data_ptr(), B, N, M)
    launches["nearest_neighbor"] += 1
    return sq, idx


def signed_nearest_cuda(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch K3 on the current stream: (sq, sdot, idx) as
    ``signed_nearest_plain``."""
    B, N, M = _check(a, b, n)
    lib = _library()
    sq = torch.empty((B, N), dtype=torch.float32, device=a.device)
    sdot = torch.empty_like(sq)
    idx = torch.empty((B, N), dtype=torch.int32, device=a.device)
    _build.launch(lib.nn_signed_f32, a, a.data_ptr(), b.data_ptr(),
                  n.data_ptr(), sq.data_ptr(), sdot.data_ptr(),
                  idx.data_ptr(), B, N, M)
    launches["signed_nearest"] += 1
    return sq, sdot, idx


def _signed_nearest_pruned_launch(a: torch.Tensor, b: torch.Tensor,
                                  n: torch.Tensor, delta: float):
    """K2's launch: (sq, sdot, idx) and the prologue's flags [B, n_seg],
    count [B] and ids [B, n_seg] (as ``segment_flags`` and
    ``segment_list_plain`` give them)."""
    B, N, M = _check(a, b, n)
    lib = _library()
    n_seg = -(-M // SEGMENT)
    # one allocation for the prologue's flags, ids and count and the order
    # of the frames
    scratch = torch.empty(2 * B * (n_seg + 1), dtype=torch.int32,
                          device=a.device)
    flags = scratch[:B * n_seg].view(B, n_seg)
    ids = scratch[B * n_seg:2 * B * n_seg].view(B, n_seg)
    count, order = scratch[2 * B * n_seg:].view(2, B)
    sq = torch.empty((B, N), dtype=torch.float32, device=a.device)
    sdot = torch.empty_like(sq)
    idx = torch.empty((B, N), dtype=torch.int32, device=a.device)
    _build.launch(lib.nn_signed_pruned_f32, a, a.data_ptr(), b.data_ptr(),
                  n.data_ptr(), flags.data_ptr(), count.data_ptr(),
                  ids.data_ptr(), order.data_ptr(), sq.data_ptr(),
                  sdot.data_ptr(), idx.data_ptr(), B, N, M,
                  delta_squared(delta), flag_threshold(delta))
    launches["signed_nearest_pruned"] += 1
    return sq, sdot, idx, flags, count, ids


def signed_nearest_pruned_cuda(a: torch.Tensor, b: torch.Tensor,
                               n: torch.Tensor, delta: float = 0.25
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Launch K2 on the current stream: (sq, sdot, idx) as
    ``signed_nearest_pruned_plain``."""
    return _signed_nearest_pruned_launch(a, b, n, delta)[:3]


# -- gradients ----------------------------------------------------------------

def _rows_at(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, M, 3], idx [B, N] -> [B, N, 3]."""
    return points.gather(1, idx.to(torch.int64)[..., None].expand(-1, -1, 3))


def _scatter_rows(like: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """Zeros shaped as ``like`` [B, M, 3] with ``rows`` [B, N, 3] added at
    ``idx`` [B, N]."""
    return torch.zeros_like(like).scatter_add_(
        1, idx.to(torch.int64)[..., None].expand(-1, -1, 3), rows)


def by_device(a: torch.Tensor, cuda_fn, plain_fn):
    """The kernel's wrapper for a CUDA tensor, the plain version for a CPU
    tensor; any other device raises."""
    if a.is_cuda:
        return cuda_fn
    if a.device.type != "cpu":
        raise ValueError(f"no nearest-neighbour path for device {a.device}")
    return plain_fn


class _NearestNeighbor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        sq, idx = by_device(a, nearest_neighbor_cuda,
                             nearest_neighbor_plain)(a, b)
        ctx.save_for_backward(a, b, idx)
        ctx.mark_non_differentiable(idx)
        return sq, idx

    @staticmethod
    def backward(ctx, gd, _):
        a, b, idx = ctx.saved_tensors
        ga = 2.0 * gd[..., None] * (a - _rows_at(b, idx))
        return ga, _scatter_rows(b, idx, -ga)


class _SignedNearest(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, n):
        sq, sdot, idx = by_device(a, signed_nearest_cuda,
                                   signed_nearest_plain)(a, b, n)
        ctx.save_for_backward(a, b, n, idx)
        ctx.mark_non_differentiable(idx)
        return sq, sdot, idx

    @staticmethod
    def backward(ctx, gd, gs, _):
        a, b, n, idx = ctx.saved_tensors
        n_near = _rows_at(n, idx)
        diff = a - _rows_at(b, idx)
        ga = 2.0 * gd[..., None] * diff + gs[..., None] * n_near
        gb_rows = -2.0 * gd[..., None] * diff - gs[..., None] * n_near
        return (ga, _scatter_rows(b, idx, gb_rows),
                _scatter_rows(n, idx, gs[..., None] * diff))


def nearest_neighbor_diff(a: torch.Tensor, b: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 with its gradient: (sq, idx) of a [B, N, 3] against b [B, M, 3],
    the kernel on CUDA tensors and the plain version on CPU tensors,
    differentiable in a and b through ``sq``."""
    return _NearestNeighbor.apply(a, b)


def signed_nearest_diff(a: torch.Tensor, b: torch.Tensor, n: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 with its gradient: (sq, sdot, idx), differentiable in a, b and n
    through ``sq`` and ``sdot``."""
    return _SignedNearest.apply(a, b, n)
