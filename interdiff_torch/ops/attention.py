"""Attention math of the InterDiff transformer blocks
(`interdiff_tpu/ops/attention.py`), as plain tensor code, batch-first.

* QaN banded attention: learned queries, unit-normalised per head and
  depth-scaled, attend over a tridiagonal band (|t - j| <= 1) with rotary
  position embedding over the full ``d_model`` on q and k, and scores scaled
  by ``D**-0.5`` on top of the query depth-scaling.
* Dense multi-head attention with ``torch.nn.MultiheadAttention`` math,
  optionally under an additive mask (the text tower's causal mask,
  :func:`causal_mask`).

Sequences are 20-35 tokens, so the band is a dense T x T mask.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_MASK_VALUE = -0.5 * torch.finfo(torch.float32).max


def rotary_cos_sin(seq_len: int, dim: int, *, device=None,
                   dtype=torch.float32):
    """cos/sin tables [T, dim] in the half-split layout,
    ``freqs = cat((t * inv_freq, t * inv_freq))``."""
    inv_freq = 1.0 / (10000.0 ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    freqs = torch.cat([freqs, freqs], dim=-1)
    return freqs.cos().to(dtype), freqs.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """x: [..., T, D]; cos/sin: [T, D]."""
    return x * cos + _rotate_half(x) * sin


def normalize_queries(queries: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Unit-normalise each head chunk (+1e-6) and divide by sqrt(head_dim)."""
    n, d = queries.shape
    head_dim = d // num_heads
    q = queries.reshape(n, num_heads, head_dim)
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-6)
    q = q / math.sqrt(head_dim)
    return q.reshape(n, d)


def banded_qan_attention(queries: torch.Tensor, x: torch.Tensor, *,
                         num_heads: int) -> torch.Tensor:
    """QaN local attention (`sublayers.py:180-189`).

    queries: [N, D] raw learned queries; x: [B, T, D], both keys and values.
    Returns [B, N, T, D] per-query outputs (callers mix them with ``wk``).
    """
    B, T, D = x.shape
    q = normalize_queries(queries, num_heads)  # [N, D]
    cos, sin = rotary_cos_sin(T, D, device=x.device, dtype=x.dtype)
    q_rot = q[:, None, :] * cos[None] + _rotate_half(q)[:, None, :] * sin[None]
    k_rot = apply_rotary(x, cos, sin)
    scores = torch.einsum("ntd,bjd->bntj", q_rot, k_rot) * D ** -0.5
    idx = torch.arange(T, device=x.device)
    off_band = (idx[:, None] - idx[None, :]).abs() > 1
    scores = scores.masked_fill(off_band, _MASK_VALUE)  # [B, N, T, T]
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bntj,bjd->bntd", probs, x)


def causal_mask(seq_len: int) -> torch.Tensor:
    """The additive causal mask [T, T]: 0 on and below the diagonal, -inf
    above it (CLIP's ``build_attention_mask``)."""
    return torch.full((seq_len, seq_len), float("-inf")).triu_(1)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         num_heads: int,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product MHA on projected q [B, Tq, D] and k/v [B, Tk, D],
    per-head scale 1/sqrt(D/H); ``mask`` [Tq, Tk] is added to the scores
    before the softmax (none: unmasked)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = num_heads
    hd = D // H
    qh = q.reshape(B, Tq, H, hd).transpose(1, 2)
    kh = k.reshape(B, Tk, H, hd).transpose(1, 2)
    vh = v.reshape(B, Tk, H, hd).transpose(1, 2)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs, vh)
    return out.transpose(1, 2).reshape(B, Tq, D)
