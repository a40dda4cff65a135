"""One whole PointNet++ MSG radius scale in one pass: kernel K6.

Counterpart of `interdiff_tpu/ops/pallas_sa.py` (`fused_sa_scale`,
`folded_affine`).  A scale is the ball query and grouping of
K1, the 1x1-conv / BatchNorm / ReLU chain with the inference-mode BatchNorm
folded into an affine ``y = a * (x @ W) + b``, and the maximum over the
``nsample`` neighbours: xyz [B, N, 3] and features [B, N, F] in,
[B, M, c_out] out.  On a CUDA tensor the wrapper launches the hand-written
kernel `csrc/sa.cu`, which replaces the Pallas kernel `_sa_pallas` and keeps
the grouped tensor and every hidden activation out of device memory; on a
CPU tensor it runs ``sa_plain``, the plain PyTorch version of the same
arithmetic.  There is no fallback between the two: a CUDA tensor launches
the kernel or raises, also when it lies outside the kernel's gate (float32,
at most ``MAX_C`` data channels).  The encoder takes this route per radius
scale when ``INTERDIFF_FUSED_SA`` is set (`models/pointnet.py`); the default
route is K1 + `SharedMLP` + ``amax``.

Bound at the main-path shape (B=32, N=2048, M=1024): bytes for the S=16
scale (d2t [B, N, M] read up to each query's last slot), operations for the
S=32 scale (6.7 GFLOP of chain); the walk's dependent loads and the chain's
dependent product-and-sum steps set the time, about 30 times the bound on an
H100.

Gradient (`_fsa_fwd`, `_fsa_bwd`): ``fused_sa_scale`` is a
`torch.autograd.Function`.  When a gradient is wanted the forward is one
launch of the kernel's ``with_grouped`` variant, which also writes the
recentered grouped tensor [B, M, S, C] (bitwise K1's output) and keeps it for
the backward; otherwise it is the launch without it.  The backward is the
VJP of the folded chain and the maximum over that tensor (``_mlp_max``) in
plain PyTorch, in full float32: the JAX package has no backward kernel here
either, and these products are what XLA computes outside any kernel.  The
maximum is ``amax``, which like ``jnp.max`` splits the cotangent evenly over
tied slots (short rows repeat a slot, and ReLU ties many at 0).  The cotangent
of the grouped tensor goes on through K1's `Function` (`ops/group.py`) only
when xyz, new_xyz or the features ask for a gradient; ``d2t`` gets none.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from interdiff_torch.ops import _build
from interdiff_torch.ops.group import (
    MAX_C,
    fused_query_group,
    group_plain,
    pairwise_sqdist_t,
)
from interdiff_torch.ops.pointcloud import radius_sq

MAX_LAYERS = 4  # longest chain the kernel takes
MAX_WIDTH = 128  # widest layer the kernel takes
BN_EPS = 1e-5

Affine = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # W [cin, cout], a, b

# launches of the CUDA kernel in this process; a run resets it to 0 and
# reads it back to show that the path went through the kernel
launches = 0

_lib = None


def build() -> str:
    """Compile `csrc/sa.cu` into a shared library (once per source hash) and
    return its path."""
    return _build.build("sa")


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sa_scale_f32.argtypes = (
            [ptr] * 6 + [i32] * 5 + [ctypes.c_float, i32,
                                     ctypes.POINTER(i32), ptr])
        lib.sa_scale_f32.restype = i32
        for fn in (lib.sa_max_layers, lib.sa_max_width):
            fn.argtypes = []
            fn.restype = i32
        if (lib.sa_max_layers(), lib.sa_max_width()) != (MAX_LAYERS,
                                                         MAX_WIDTH):
            raise RuntimeError("csrc/sa.cu and ops/sa.py disagree on the "
                               "kernel's limits")
        _lib = lib
    return _lib


def folded_affine(shared_mlp: torch.nn.Module) -> Tuple[Affine, ...]:
    """(W [cin, cout], a [cout], b [cout]) per layer of a
    `models.pointnet.SharedMLP`: conv + inference-mode BatchNorm as
    ``y = a * (x @ W) + b`` with ``a = scale * rsqrt(var + eps)`` and
    ``b = bias - a * mean``.  Part of the graph: gradients reach the conv
    weights and all four BatchNorm tensors through it."""
    out = []
    for i in range(shared_mlp.depth):
        conv = getattr(shared_mlp, f"conv{i}")
        bn = getattr(shared_mlp, f"bn{i}")
        a = bn.weight * torch.rsqrt(bn.running_var + BN_EPS)
        out.append((conv.weight.t(), a, bn.bias - a * bn.running_mean))
    return tuple(out)


def sa_plain(d2t: torch.Tensor, data: torch.Tensor, new_xyz: torch.Tensor,
             params: Sequence[Affine], radius: float, nsample: int,
             with_grouped: bool = False):
    """Plain PyTorch version of the kernel, the same arithmetic step by
    step: grouping by `query_and_group` on the same distances, then per
    layer the sum over the input channels in increasing ``k`` with one
    rounded product and one rounded sum each, the affine, the ReLU, and at
    the end the maximum over the neighbours.

    d2t [B, N, M], data [B, N, C] (xyz first), new_xyz [B, M, 3] ->
    [B, M, c_out], with ``with_grouped`` also the grouped tensor
    [B, M, nsample, C].
    """
    grouped = group_plain(d2t, data, new_xyz, radius, nsample)  # [B, M, S, C]
    h = grouped
    for w, a, b in params:
        acc = torch.zeros(h.shape[:-1] + (w.shape[1],), dtype=h.dtype,
                          device=h.device)
        for k in range(w.shape[0]):
            acc = acc + h[..., k:k + 1] * w[k]
        h = torch.relu(acc * a + b)
    out = h.amax(dim=2)
    return (out, grouped) if with_grouped else out


def check_gate(data: torch.Tensor) -> None:
    """Raise on a data tensor [B, N, C] the kernel does not take: the gate
    of the JAX package's `_fused_sa_impl` (float32 and C <= 8; the port
    always groups with the xyz channels)."""
    if data.dtype != torch.float32:
        raise ValueError(f"K6 takes float32 data, got {data.dtype}")
    if not 3 <= data.shape[-1] <= MAX_C:
        raise ValueError(f"K6 takes 3 to {MAX_C} data channels (xyz first), "
                         f"got {data.shape[-1]}")


def sa_cuda(d2t: torch.Tensor, data: torch.Tensor, new_xyz: torch.Tensor,
            params: Sequence[Affine], radius: float, nsample: int,
            with_grouped: bool = False):
    """Launch K6 on the current stream: the same function as ``sa_plain``,
    on contiguous float32 CUDA tensors; ``with_grouped`` picks the variant
    that also writes the grouped tensor."""
    global launches
    check_gate(data)
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
    widths = [C]
    for w, a, b in params:
        if w.shape[0] != widths[-1] or a.shape != (w.shape[1],) \
                or b.shape != (w.shape[1],):
            raise ValueError(f"layer {len(widths) - 1}: W "
                             f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                             f"{tuple(b.shape)} do not chain from "
                             f"{widths[-1]} channels")
        widths.append(w.shape[1])
    if not 1 <= len(params) <= MAX_LAYERS or max(widths) > MAX_WIDTH \
            or N < 1 or nsample < 1 or B > 65535:
        raise ValueError(f"unsupported sizes B={B} N={N} S={nsample} "
                         f"widths={widths}")
    flat = torch.cat([t.reshape(-1) for layer in params for t in (
        layer[0].contiguous(), layer[1], layer[2])])
    if not flat.is_cuda or flat.dtype != torch.float32 \
            or flat.device != d2t.device:
        raise ValueError(f"the folded weights must be float32 on "
                         f"{d2t.device}, got {flat.dtype} on {flat.device}")
    lib = _library()
    out = torch.empty((B, M, widths[-1]), dtype=torch.float32,
                      device=d2t.device)
    grouped = torch.empty((B, M, nsample, C), dtype=torch.float32,
                          device=d2t.device) if with_grouped else None
    with torch.cuda.device(d2t.device):
        err = lib.sa_scale_f32(
            d2t.data_ptr(), data.data_ptr(), new_xyz.data_ptr(),
            flat.data_ptr(), out.data_ptr(),
            grouped.data_ptr() if with_grouped else None,
            B, N, M, C, nsample,
            radius_sq(radius), len(params),
            (ctypes.c_int * len(widths))(*widths),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sa_scale_f32 launch failed: CUDA error {err}")
    launches += 1
    return (out, grouped) if with_grouped else out


def _mlp_max(grouped: torch.Tensor, params: Sequence[Affine]) -> torch.Tensor:
    """The folded chain and the maximum over the neighbours of a grouped
    tensor [B, M, S, C] -> [B, M, c_out], with library products: the function
    the backward differentiates (`_mlp_max` of the JAX package)."""
    h = grouped
    for w, a, b in params:
        h = torch.relu(torch.matmul(h, w) * a + b)
    return h.amax(dim=2)


class _FusedSaScale(torch.autograd.Function):
    """K6 (CUDA) or its plain version (CPU) forward, with the grouped tensor
    kept when a gradient is wanted; backward by the VJP of ``_mlp_max``."""

    @staticmethod
    def forward(ctx, xyz, new_xyz, features, d2t, radius, nsample, keep,
                *flat):
        params = tuple(zip(flat[0::3], flat[1::3], flat[2::3]))
        data = xyz if features is None else torch.cat([xyz, features], dim=-1)
        if d2t.is_cuda:
            res = sa_cuda(d2t.contiguous(), data.contiguous(),
                          new_xyz.contiguous(), params, radius, nsample, keep)
        elif d2t.device.type == "cpu":
            res = sa_plain(d2t, data, new_xyz, params, radius, nsample, keep)
        else:
            raise ValueError(f"no K6 path for device {d2t.device}")
        if not keep:
            return res
        out, grouped = res
        ctx.save_for_backward(xyz, new_xyz, features, d2t, grouped, *flat)
        ctx.radius, ctx.nsample = radius, nsample
        return out

    @staticmethod
    def backward(ctx, g):
        xyz, new_xyz, features, d2t, grouped, *flat = ctx.saved_tensors
        need = ctx.needs_input_grad
        to_inputs = any(n and t is not None for n, t in zip(
            need[:3], (xyz, new_xyz, features)))
        if not to_inputs and not any(need[7:]):  # only d2t asked
            return (None,) * len(need)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        # full float32, as the forward's sums: a TF32 replay could pick
        # another neighbour at a near-tie of the maximum than the kernel did
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.enable_grad():
                grouped_ = grouped.detach().requires_grad_(to_inputs)
                flat_ = [t.detach().requires_grad_(n)
                         for t, n in zip(flat, need[7:])]
                out = _mlp_max(grouped_, tuple(zip(
                    flat_[0::3], flat_[1::3], flat_[2::3])))
                wrt = [t for t in [grouped_] + flat_ if t.requires_grad]
                grads = dict(zip(map(id, wrt),
                                 torch.autograd.grad(out, wrt, g)))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        g_inputs = (None, None, None)
        if to_inputs:
            with torch.enable_grad():
                inputs = [None if t is None else t.detach().requires_grad_(
                    bool(n)) for t, n in zip((xyz, new_xyz, features),
                                             need[:3])]
                replay = fused_query_group(*inputs, ctx.radius, ctx.nsample,
                                           d2t.detach())
                wrt = [t for t in inputs if t is not None and t.requires_grad]
                got = dict(zip(map(id, wrt), torch.autograd.grad(
                    replay, wrt, grads[id(grouped_)])))
            g_inputs = tuple(None if t is None else got.get(id(t))
                             for t in inputs)
        return g_inputs + (None, None, None, None) + tuple(
            grads.get(id(t)) for t in flat_)


def fused_sa_scale(xyz: torch.Tensor, new_xyz: torch.Tensor,
                   features: Optional[torch.Tensor],
                   params: Sequence[Affine], radius: float, nsample: int,
                   d2t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MSG radius scale through K6: xyz [B, N, 3], new_xyz [B, M, 3],
    features [B, N, F] | None, ``params`` from :func:`folded_affine`,
    ``d2t`` the optional shared :func:`pairwise_sqdist_t` -> [B, M, c_out],
    differentiable in ``params``, xyz, new_xyz and the features."""
    if d2t is None:
        d2t = pairwise_sqdist_t(xyz, new_xyz)
    flat = [t for layer in params for t in layer]
    # the grouped tensor is kept only when a backward can follow
    keep = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in [xyz, new_xyz, features, d2t] + flat)
    return _FusedSaScale.apply(xyz, new_xyz, features, d2t, radius, nsample,
                               keep, *flat)
