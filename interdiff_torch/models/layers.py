"""Transformer building blocks (`interdiff_tpu/models/layers.py:33-327`),
batch-first [B, T, D].

Submodule and parameter names follow the flax modules so that the weight
bridge (`utils/convert.py`) is a renaming: dense layers are ``nn.Linear``
(flax ``kernel`` is the transposed ``weight``), ``TorchMHA`` keeps the
packed ``in_proj_kernel`` [D, 3D] layout, QaN layers keep ``queries``
[N, D] and ``wk`` [N, 1].  Every layer is post-norm, LayerNorm eps is 1e-5,
GELU is the exact erf form.  Dropout is inference-only (rate 0 in every
reference run), so it is not modelled.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from interdiff_torch.ops.attention import (
    banded_qan_attention,
    multi_head_attention,
)


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """The sin/cos positional table of `interdiff/model/layers.py:9-21`."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEncoding(nn.Module):
    """x + pe[:T] (`layers.py:9-26`); x is [B, T, D]."""

    def __init__(self, d_model: int, max_len: int = 5000):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(max_len, d_model)),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[None, : x.shape[1]].to(x.dtype)


class TimestepEmbedder(nn.Module):
    """MLP(SiLU) over the positional-table row of t (`layers.py:29-43`):
    timesteps [B] -> [B, 1, D]; float timesteps are floor-cast."""

    def __init__(self, latent_dim: int, max_len: int = 5000):
        super().__init__()
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(max_len, latent_dim)),
            persistent=False)
        self.fc1 = nn.Linear(latent_dim, latent_dim)
        self.fc2 = nn.Linear(latent_dim, latent_dim)

    def forward(self, timesteps: torch.Tensor) -> torch.Tensor:
        h = self.pe[timesteps.to(torch.int64)][:, None, :]
        return self.fc2(F.silu(self.fc1(h)))


class TorchMHA(nn.Module):
    """``torch.nn.MultiheadAttention`` math with the flax parameter layout:
    ``in_proj_kernel`` [D, 3D] (q | k | v columns), ``in_proj_bias`` [3D],
    ``out_proj`` Linear."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_kernel = nn.Parameter(torch.empty(d_model, 3 * d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        bound = 1.0 / math.sqrt(d_model)
        nn.init.uniform_(self.in_proj_kernel, -bound, bound)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, query, key, value):
        d = self.in_proj_bias.shape[0] // 3
        w, b = self.in_proj_kernel, self.in_proj_bias
        q = query @ w[:, :d] + b[:d]
        k = key @ w[:, d:2 * d] + b[d:2 * d]
        v = value @ w[:, 2 * d:] + b[2 * d:]
        return self.out_proj(
            multi_head_attention(q, k, v, num_heads=self.num_heads))


def _activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")  # exact erf form
    raise ValueError(f"activation must be relu/gelu, got {name}")


class FeedForward(nn.Module):
    """linear2(act(linear1(x))) (`sublayers.py:201-203`)."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 activation: str = "gelu"):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.act = _activation(activation)

    def forward(self, x):
        return self.linear2(self.act(self.linear1(x)))


def _layer_norm(d_model: int) -> nn.LayerNorm:
    return nn.LayerNorm(d_model, eps=1e-5)


class EncoderLayer(nn.Module):
    """Post-norm ``nn.TransformerEncoderLayer``; ``memory`` is ignored."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 activation: str = "gelu"):
        super().__init__()
        self.self_attn = TorchMHA(d_model, num_heads)
        self.norm1 = _layer_norm(d_model)
        self.ff = FeedForward(d_model, dim_feedforward, activation)
        self.norm2 = _layer_norm(d_model)

    def forward(self, x, memory=None):
        x = self.norm1(x + self.self_attn(x, x, x))
        return self.norm2(x + self.ff(x))


class DecoderLayer(nn.Module):
    """Post-norm ``nn.TransformerDecoderLayer``."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 activation: str = "gelu"):
        super().__init__()
        self.self_attn = TorchMHA(d_model, num_heads)
        self.norm1 = _layer_norm(d_model)
        self.multihead_attn = TorchMHA(d_model, num_heads)
        self.norm2 = _layer_norm(d_model)
        self.ff = FeedForward(d_model, dim_feedforward, activation)
        self.norm3 = _layer_norm(d_model)

    def forward(self, x, memory):
        x = self.norm1(x + self.self_attn(x, x, x))
        x = self.norm2(x + self.multihead_attn(x, memory, memory))
        return self.norm3(x + self.ff(x))


class _QaNBlock(nn.Module):
    """Banded rotary attention of learned queries, mixed by ``wk``."""

    def __init__(self, d_model: int, num_heads: int, num_queries: int):
        super().__init__()
        self.num_heads = num_heads
        self.queries = nn.Parameter(
            torch.randn(num_queries, d_model) / math.sqrt(d_model))
        self.wk = nn.Parameter(
            torch.randn(num_queries, 1) / math.sqrt(num_queries))

    def _qa_block(self, x):
        out = banded_qan_attention(self.queries, x, num_heads=self.num_heads)
        # einsum bntd,nk->bktd with k == 1 (`sublayers.py:188`)
        return torch.einsum("bntd,nk->bktd", out, self.wk)[:, 0]


class QaNEncoderLayer(_QaNBlock):
    """`TransformerEncoderLayerQaN` (`sublayers.py:37-203`), post-norm; the
    residual is taken from ``src`` (stochastic depth at rate 0)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 activation: str = "gelu", num_queries: int = 10):
        super().__init__(d_model, num_heads, num_queries)
        self.norm1 = _layer_norm(d_model)
        self.ff = FeedForward(d_model, dim_feedforward, activation)
        self.norm2 = _layer_norm(d_model)

    def forward(self, src, memory=None):
        x = self.norm1(src + self._qa_block(src))
        x = self.norm2(x + self.ff(x))
        return src + (x - src)


class QaNDecoderLayer(_QaNBlock):
    """`TransformerDecoderLayerQaN` (`sublayers.py:206-375`): QaN self-attn,
    dense cross-attn to memory, FFN; post-norm; residual from ``tgt``."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 activation: str = "gelu", num_queries: int = 10):
        super().__init__(d_model, num_heads, num_queries)
        self.norm1 = _layer_norm(d_model)
        self.multihead_attn = TorchMHA(d_model, num_heads)
        self.norm2 = _layer_norm(d_model)
        self.ff = FeedForward(d_model, dim_feedforward, activation)
        self.norm3 = _layer_norm(d_model)

    def forward(self, tgt, memory):
        x = self.norm1(tgt + self._qa_block(tgt))
        x = self.norm2(x + self.multihead_attn(x, memory, memory))
        x = self.norm3(x + self.ff(x))
        return tgt + (x - tgt)


_KINDS = {"enc": EncoderLayer, "qan_enc": QaNEncoderLayer,
          "dec": DecoderLayer, "qan_dec": QaNDecoderLayer}


class TransformerStack(nn.Module):
    """Heterogeneous layer stack ``layer_0 .. layer_{n-1}``
    (`layers.py:177-269`); ``kinds`` entries are 'enc' | 'qan_enc' | 'dec' |
    'qan_dec', and encoder kinds ignore ``memory``."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 kinds: Sequence[str], activation: str = "gelu"):
        super().__init__()
        self.kinds = tuple(kinds)
        for i, kind in enumerate(self.kinds):
            self.add_module(f"layer_{i}", _KINDS[kind](
                d_model, num_heads, dim_feedforward, activation))

    def forward(self, x, memory: Optional[torch.Tensor] = None):
        for i in range(len(self.kinds)):
            x = getattr(self, f"layer_{i}")(x, memory)
        return x


def mdm_stack_kinds(num_layers: int, cross: bool) -> Tuple[str, ...]:
    """First/last vanilla, middle QaN (`model/diffusion_skeleton.py:24-127`)."""
    if cross:
        return ("dec",) + ("qan_dec",) * (num_layers - 2) + ("dec",)
    return ("enc",) + ("qan_enc",) * (num_layers - 2) + ("enc",)
