"""One whole PointNet++ MSG radius scale in one pass: kernel K6.

Counterpart of `interdiff_tpu/ops/pallas_sa.py` (`fused_sa_scale`,
`folded_affine`), forward only.  A scale is the ball query and grouping of
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
H100.  The kernel's second output of the JAX package (the grouped tensor kept
for the backward pass) and the backward pass itself are not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from interdiff_torch.ops import _build
from interdiff_torch.ops.group import MAX_C, group_plain, pairwise_sqdist_t
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
            [ptr] * 5 + [i32] * 5 + [ctypes.c_float, i32,
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
    ``b = bias - a * mean``.  Detached: this route is forward only."""
    out = []
    for i in range(shared_mlp.depth):
        conv = getattr(shared_mlp, f"conv{i}")
        bn = getattr(shared_mlp, f"bn{i}")
        a = bn.weight.detach() * torch.rsqrt(bn.running_var + BN_EPS)
        out.append((conv.weight.detach().t(), a,
                    bn.bias.detach() - a * bn.running_mean))
    return tuple(out)


def sa_plain(d2t: torch.Tensor, data: torch.Tensor, new_xyz: torch.Tensor,
             params: Sequence[Affine], radius: float, nsample: int
             ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, the same arithmetic step by
    step: grouping by `query_and_group` on the same distances, then per
    layer the sum over the input channels in increasing ``k`` with one
    rounded product and one rounded sum each, the affine, the ReLU, and at
    the end the maximum over the neighbours.

    d2t [B, N, M], data [B, N, C] (xyz first), new_xyz [B, M, 3] ->
    [B, M, c_out].
    """
    h = group_plain(d2t, data, new_xyz, radius, nsample)  # [B, M, S, C]
    for w, a, b in params:
        acc = torch.zeros(h.shape[:-1] + (w.shape[1],), dtype=h.dtype,
                          device=h.device)
        for k in range(w.shape[0]):
            acc = acc + h[..., k:k + 1] * w[k]
        h = torch.relu(acc * a + b)
    return h.amax(dim=2)


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
            params: Sequence[Affine], radius: float, nsample: int
            ) -> torch.Tensor:
    """Launch K6 on the current stream: the same function as ``sa_plain``,
    on contiguous float32 CUDA tensors."""
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
    with torch.cuda.device(d2t.device):
        err = lib.sa_scale_f32(
            d2t.data_ptr(), data.data_ptr(), new_xyz.data_ptr(),
            flat.data_ptr(), out.data_ptr(), B, N, M, C, nsample,
            radius_sq(radius), len(params),
            (ctypes.c_int * len(widths))(*widths),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sa_scale_f32 launch failed: CUDA error {err}")
    launches += 1
    return out


@torch.no_grad()
def fused_sa_scale(xyz: torch.Tensor, new_xyz: torch.Tensor,
                   features: Optional[torch.Tensor],
                   params: Sequence[Affine], radius: float, nsample: int,
                   d2t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One MSG radius scale through K6: xyz [B, N, 3], new_xyz [B, M, 3],
    features [B, N, F] | None, ``params`` from :func:`folded_affine`,
    ``d2t`` the optional shared :func:`pairwise_sqdist_t` -> [B, M, c_out].
    Forward only: nothing here records a gradient."""
    data = xyz if features is None else torch.cat([xyz, features], dim=-1)
    if d2t is None:
        d2t = pairwise_sqdist_t(xyz, new_xyz)
    if d2t.is_cuda:
        return sa_cuda(d2t.contiguous(), data.contiguous(),
                       new_xyz.contiguous(), params, radius, nsample)
    if d2t.device.type != "cpu":
        raise ValueError(f"no K6 path for device {d2t.device}")
    return sa_plain(d2t, data, new_xyz, params, radius, nsample)
