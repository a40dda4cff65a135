"""Transformer building blocks (`interdiff_tpu/models/layers.py:33-327`),
batch-first [B, T, D], and the ST-GCNN graph blocks of the correction
networks (`:335-398`), channels-last [B, T, V, C].

Submodule and parameter names follow the flax modules so that the weight
bridge (`utils/convert.py`) is a renaming: dense layers are ``nn.Linear``
(flax ``kernel`` is the transposed ``weight``), ``TorchMHA`` keeps the
packed ``in_proj_kernel`` [D, 3D] layout, QaN layers keep ``queries``
[N, D] and ``wk`` [N, 1].  Every layer here is post-norm (the text tower's
pre-norm layer is `models/clip_text.py`'s), LayerNorm eps is 1e-5, GELU is
the exact erf form (``quick_gelu`` is CLIP's, by name).  Dropout sits where
the JAX package puts it (after the positional encoding, inside the
feed-forward block, on each sublayer's output before its residual; not
inside attention) and acts in train mode only (``train=True``), its mask
drawn from an explicit ``torch.Generator`` (:func:`dropout`); at rate 0
or in eval mode a layer computes exactly what it does without dropout and
draws nothing.  Both
BatchNorms have flax's train mode: ``BatchNormState`` (the correction
networks) keeps its running statistics as buffers, state that
the correction trainers move by momentum and never optimise;
``BatchNorm`` (the PointNet++ encoder) keeps them as parameters, because
the JAX package's default diffusion train step optimises them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from interdiff_torch.ops import packed_attention as k7
from interdiff_torch.ops.attention import (
    banded_qan_attention,
    multi_head_attention,
)
from interdiff_torch.parallel.mesh import active_mesh, all_reduce_sum


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``nn.Dropout``: in train mode with ``rate`` > 0, each element
    kept with probability 1 - rate (a uniform draw from ``generator`` below
    it) and scaled by 1 / (1 - rate), the others zeroed; otherwise ``x``
    itself, with no draw.  Under a data mesh of more than one rank the mask
    comes from the rank's own stream (`DataMesh.rank_stream`): no two ranks
    share masks.  At one rank it comes from ``generator``, as without a
    mesh."""
    if not train or rate == 0.0:
        return x
    mesh = active_mesh()
    if mesh is not None and mesh.size > 1:
        generator = mesh.rank_stream(generator, x.device)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


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
    """x + pe[:T], then dropout (`layers.py:9-26`); x is [B, T, D]."""

    def __init__(self, d_model: int, dropout: float = 0.0,
                 max_len: int = 5000):
        super().__init__()
        self.dropout = dropout
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(max_len, d_model)),
            persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x + self.pe[None, : x.shape[1]].to(x.dtype),
                       self.dropout, train, generator)


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

    def forward(self, query, key, value, mask=None):
        """``mask``: an additive [Tq, Tk] mask on the scores (none:
        unmasked)."""
        d = self.in_proj_bias.shape[0] // 3
        w, b = self.in_proj_kernel, self.in_proj_bias
        q = query @ w[:, :d] + b[:d]
        k = key @ w[:, d:2 * d] + b[d:2 * d]
        v = value @ w[:, 2 * d:] + b[2 * d:]
        return self.out_proj(
            multi_head_attention(q, k, v, num_heads=self.num_heads,
                                 mask=mask))


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's ``QuickGELU``: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def _activation(name: str):
    if name == "relu":
        return F.relu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")  # exact erf form
    if name == "quick_gelu":
        return quick_gelu
    raise ValueError(f"activation must be relu/gelu/quick_gelu, got {name}")


class FeedForward(nn.Module):
    """linear2(dropout(act(linear1(x)))) (`sublayers.py:201-203`)."""

    def __init__(self, d_model: int, dim_feedforward: int,
                 activation: str = "gelu", dropout: float = 0.0):
        super().__init__()
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.act = _activation(activation)
        self.dropout = dropout

    def forward(self, x, train: bool = False, generator=None):
        return self.linear2(dropout(self.act(self.linear1(x)), self.dropout,
                                    train, generator))


def _layer_norm(d_model: int) -> nn.LayerNorm:
    return nn.LayerNorm(d_model, eps=1e-5)


class EncoderLayer(nn.Module):
    """Post-norm ``nn.TransformerEncoderLayer``; ``memory`` is ignored."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 activation: str = "gelu", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = TorchMHA(d_model, num_heads)
        self.norm1 = _layer_norm(d_model)
        self.ff = FeedForward(d_model, dim_feedforward, activation, dropout)
        self.norm2 = _layer_norm(d_model)

    def forward(self, x, memory=None, train: bool = False, generator=None):
        def drop(h):
            return dropout(h, self.dropout, train, generator)

        x = self.norm1(x + drop(self.self_attn(x, x, x)))
        return self.norm2(x + drop(self.ff(x, train, generator)))


class PackedEncoderLayer(EncoderLayer):
    """`EncoderLayer` (MDM's stack, `models/mdm_text.py`) whose
    self-attention, on the card without a gradient and out of training, is
    two launches: one packed QKV product (``torch.addmm``, the bias in its
    epilogue) and kernel K7 (`ops/packed_attention.py`), which reads q, k
    and v in place from it and writes the heads concatenated for
    ``out_proj``.  Anywhere else it is `EncoderLayer.forward` itself.  The
    parameters and state-dict keys are `EncoderLayer`'s."""

    def packed_path(self, x: torch.Tensor, train: bool) -> bool:
        """Whether a call on ``x`` takes the packed path: CUDA, no
        gradient recorded, ``train`` off.  There K7 runs or, for a head
        size it is not built for, raises."""
        return x.is_cuda and not train and not torch.is_grad_enabled()

    def forward(self, x, memory=None, train: bool = False, generator=None):
        if not self.packed_path(x, train):
            return super().forward(x, memory, train, generator)
        B, T, D = x.shape
        attn = self.self_attn
        qkv = torch.addmm(attn.in_proj_bias, x.reshape(B * T, D),
                          attn.in_proj_kernel)
        a = k7.packed_attention(qkv.view(B, T, 3 * D), attn.num_heads)
        x = self.norm1(x + attn.out_proj(a))
        return self.norm2(x + self.ff(x))


class DecoderLayer(nn.Module):
    """Post-norm ``nn.TransformerDecoderLayer``."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 activation: str = "gelu", dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.self_attn = TorchMHA(d_model, num_heads)
        self.norm1 = _layer_norm(d_model)
        self.multihead_attn = TorchMHA(d_model, num_heads)
        self.norm2 = _layer_norm(d_model)
        self.ff = FeedForward(d_model, dim_feedforward, activation, dropout)
        self.norm3 = _layer_norm(d_model)

    def forward(self, x, memory, train: bool = False, generator=None):
        def drop(h):
            return dropout(h, self.dropout, train, generator)

        x = self.norm1(x + drop(self.self_attn(x, x, x)))
        x = self.norm2(x + drop(self.multihead_attn(x, memory, memory)))
        return self.norm3(x + drop(self.ff(x, train, generator)))


class _QaNBlock(nn.Module):
    """Banded rotary attention of learned queries, mixed by ``wk``."""

    def __init__(self, d_model: int, num_heads: int, num_queries: int,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.queries = nn.Parameter(
            torch.randn(num_queries, d_model) / math.sqrt(d_model))
        self.wk = nn.Parameter(
            torch.randn(num_queries, 1) / math.sqrt(num_queries))

    def _drop(self, h, train: bool, generator):
        return dropout(h, self.dropout, train, generator)

    def _qa_block(self, x, train: bool = False, generator=None):
        out = banded_qan_attention(self.queries, x, num_heads=self.num_heads)
        # einsum bntd,nk->bktd with k == 1 (`sublayers.py:188`)
        return self._drop(torch.einsum("bntd,nk->bktd", out, self.wk)[:, 0],
                          train, generator)


class QaNEncoderLayer(_QaNBlock):
    """`TransformerEncoderLayerQaN` (`sublayers.py:37-203`), post-norm; the
    residual is taken from ``src`` (stochastic depth at rate 0)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 activation: str = "gelu", dropout: float = 0.0,
                 num_queries: int = 10):
        super().__init__(d_model, num_heads, num_queries, dropout)
        self.norm1 = _layer_norm(d_model)
        self.ff = FeedForward(d_model, dim_feedforward, activation, dropout)
        self.norm2 = _layer_norm(d_model)

    def forward(self, src, memory=None, train: bool = False, generator=None):
        x = self.norm1(src + self._qa_block(src, train, generator))
        x = self.norm2(x + self._drop(self.ff(x, train, generator), train,
                                      generator))
        return src + (x - src)


class QaNDecoderLayer(_QaNBlock):
    """`TransformerDecoderLayerQaN` (`sublayers.py:206-375`): QaN self-attn,
    dense cross-attn to memory, FFN; post-norm; residual from ``tgt``."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 activation: str = "gelu", dropout: float = 0.0,
                 num_queries: int = 10):
        super().__init__(d_model, num_heads, num_queries, dropout)
        self.norm1 = _layer_norm(d_model)
        self.multihead_attn = TorchMHA(d_model, num_heads)
        self.norm2 = _layer_norm(d_model)
        self.ff = FeedForward(d_model, dim_feedforward, activation, dropout)
        self.norm3 = _layer_norm(d_model)

    def forward(self, tgt, memory, train: bool = False, generator=None):
        x = self.norm1(tgt + self._qa_block(tgt, train, generator))
        x = self.norm2(x + self._drop(self.multihead_attn(x, memory, memory),
                                      train, generator))
        x = self.norm3(x + self._drop(self.ff(x, train, generator), train,
                                      generator))
        return tgt + (x - tgt)


_KINDS = {"enc": EncoderLayer, "qan_enc": QaNEncoderLayer,
          "dec": DecoderLayer, "qan_dec": QaNDecoderLayer,
          "enc_packed": PackedEncoderLayer}


class TransformerStack(nn.Module):
    """Heterogeneous layer stack ``layer_0 .. layer_{n-1}``
    (`layers.py:177-269`); ``kinds`` entries are 'enc' | 'qan_enc' | 'dec' |
    'qan_dec' | 'enc_packed', and encoder kinds ignore ``memory``."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 kinds: Sequence[str], activation: str = "gelu",
                 dropout: float = 0.0):
        super().__init__()
        self.kinds = tuple(kinds)
        for i, kind in enumerate(self.kinds):
            self.add_module(f"layer_{i}", _KINDS[kind](
                d_model, num_heads, dim_feedforward, activation, dropout))

    def forward(self, x, memory: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        for i in range(len(self.kinds)):
            x = getattr(self, f"layer_{i}")(x, memory, train, generator)
        return x


def mdm_stack_kinds(num_layers: int, cross: bool) -> Tuple[str, ...]:
    """First/last vanilla, middle QaN (`model/diffusion_skeleton.py:24-127`)."""
    if cross:
        return ("dec",) + ("qan_dec",) * (num_layers - 2) + ("dec",)
    return ("enc",) + ("qan_enc",) * (num_layers - 2) + ("enc",)


# ---------------------------------------------------------------------------
# ST-GCNN graph blocks (`sublayers.py:378-516`, `layers.py:271-345`)
# ---------------------------------------------------------------------------


class BatchNormState(nn.Module):
    """BatchNorm over the last axis with flax's arithmetic, eps 1e-5:
    (x - mean) * (scale * rsqrt(var + eps)) + bias, the running statistics
    held as buffers (``running_mean``, ``running_var``).

    ``train=True`` is flax's `nn.BatchNorm(use_running_average=False,
    momentum=0.9)`: statistics over every axis but the last, the variance
    as max(0, E[x^2] - E[x]^2) (biased), gradients through both, and the
    running statistics moved in place to 0.9 * running + 0.1 * batch (the
    biased variance, where `torch.nn.BatchNorm` stores the unbiased one).

    Under a data mesh of more than one rank (`parallel/mesh.py::use_mesh`)
    the statistics are the global batch's, as under JAX's jit on a sharded
    batch: the per-channel sum, sum of squares and count go through a
    differentiable all-reduce (its backward all-reduces the cotangent, so
    each rank's gradient holds the cross terms through every rank's rows),
    the same arithmetic then gives mean and variance, and the running
    statistics, moved by them, stay equal on every rank.  At one rank the
    local statistics are the global ones: the arithmetic is that without a
    mesh, bit for bit.
    """

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        if not train:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            mesh = active_mesh()
            if mesh is None or mesh.size == 1:
                mean = x.mean(dim=axes)
                var = ((x * x).mean(dim=axes) - mean * mean).clamp(min=0.0)
            else:
                C = x.shape[-1]
                count = x.new_full((1,), x.numel() // C)
                sums = all_reduce_sum(torch.cat(
                    [x.sum(dim=axes), (x * x).sum(dim=axes), count]), mesh)
                mean = sums[:C] / sums[2 * C]
                var = (sums[C:2 * C] / sums[2 * C]
                       - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                for running, batch in ((self.running_mean, mean),
                                       (self.running_var, var)):
                    running.mul_(self.momentum).add_(
                        batch, alpha=1.0 - self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class BatchNorm(BatchNormState):
    """``BatchNormState`` whose running statistics are parameters.

    In the JAX package's default train step the encoder's ``batch_stats``
    sit inside the optimised tree: the loss is differentiated with respect
    to them and AdamW steps them.  So here ``running_mean`` and
    ``running_var`` (same state-dict names) are parameters; a trainer that
    wants them out of the optimiser (``bn_train_mode``) switches their
    ``requires_grad`` off and calls ``forward(x, train=True)``.
    """

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__(channels, eps, momentum)
        for name in ("running_mean", "running_var"):
            value = self._buffers.pop(name)
            self.register_parameter(name, nn.Parameter(value))


def nerf_embedder(multires: int, input_dims: int = 3, *,
                  include_input: bool = True, log_sampling: bool = True
                  ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """NeRF positional encoding factory (`interdiff/model/layers.py:48-96`,
    unused by the main path): ``(embed, out_dim)`` with ``embed(x) = [x?,
    sin(x f_0), cos(x f_0), ..., sin(x f_{L-1}), cos(x f_{L-1})]``, the
    frequencies ``2 ** linspace(0, L-1, L)`` (log sampling) or linearly
    spaced from 1 to ``2 ** (L-1)``, as float32; ``multires == -1`` is the
    identity."""
    if multires == -1:
        return (lambda x: x), input_dims
    max_freq = multires - 1
    if log_sampling:
        freqs = 2.0 ** np.linspace(0.0, max_freq, multires)
    else:
        freqs = np.linspace(2.0 ** 0.0, 2.0 ** max_freq, multires)
    freqs = [float(f) for f in freqs.astype(np.float32)]
    out_dim = (input_dims if include_input else 0) + 2 * multires * input_dims

    def embed(x: torch.Tensor) -> torch.Tensor:
        parts = [x] if include_input else []
        for f in freqs:  # [sin, cos] per frequency
            parts.append(torch.sin(x * f))
            parts.append(torch.cos(x * f))
        return torch.cat(parts, dim=-1)

    return embed, out_dim


class NormalDistDecoder(nn.Module):
    """Feature -> diagonal-Normal head (`interdiff/model/layers.py:98-108`,
    unused by the main path): ``(mu, sigma)`` with ``sigma = exp(0.5 *
    logvar)``, the input flattened to [-1, num_feat_in]; the dense layers
    keep the flax names ``mu`` and ``logvar``."""

    def __init__(self, num_feat_in: int, latent_dim: int):
        super().__init__()
        self.num_feat_in = num_feat_in
        self.mu = nn.Linear(num_feat_in, latent_dim)
        self.logvar = nn.Linear(num_feat_in, latent_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.reshape(-1, self.num_feat_in)
        return self.mu(x), torch.exp(0.5 * self.logvar(x))


def _uniform(shape: Tuple[int, ...], bound: float) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))


class GraphConv(nn.Module):
    """Learned-adjacency graph convolution, channels-last [B, T, V, C].

    version 0 (`ConvTemporalGraphical`): learned T x T temporal mixing shared
    across joints; version 1 (`ConvSpatialGraphical`): learned V x V spatial
    mixing shared across time; version 2 (`ConvSpatialTemporalGraphical`):
    per-joint T x T then per-time V x V.  The parameters ``T``, ``S``, ``A``
    keep the flax names and orientations.
    """

    def __init__(self, time_dim: int, joints_dim: int, version: int = 0):
        super().__init__()
        T, V = time_dim, joints_dim
        self.version = version
        if version == 0:
            self.T = _uniform((T, T), 1.0 / math.sqrt(T))
        elif version == 1:
            self.S = _uniform((V, V), 1.0 / math.sqrt(V))
        elif version == 2:
            self.T = _uniform((V, T, T), 1.0 / math.sqrt(T))
            self.A = _uniform((T, V, V), 1.0 / math.sqrt(V))
        else:
            raise ValueError(f"bad version {version}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.version == 0:
            return torch.einsum("btvc,tq->bqvc", x, self.T)
        if self.version == 1:
            return torch.einsum("btvc,vw->btwc", x, self.S)
        x = torch.einsum("btvc,vtq->bqvc", x, self.T)
        return torch.einsum("btvc,tvw->btwc", x, self.A)


class STGCNNLayer(nn.Module):
    """`ST_GCNN_layer` (`layers.py:271-345`), channels-last [B, T, V, C]:
    gcn -> 1x1 conv (Linear over C) -> BatchNorm -> dropout, plus a
    residual (identity, or 1x1 conv + BatchNorm when the channels change),
    then a PReLU with one shared slope (the 0-d parameter ``prelu``).

    ``forward(x, train=True)`` normalises with batch statistics and moves
    the running ones (`BatchNormState`), then drops out at ``dropout`` with
    flax's inverted scaling, the mask drawn from ``generator``.  The
    running statistics are buffers, so ``parameters()`` is exactly the
    flax ``params`` tree that the JAX correction step differentiates."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 joints_dim: int, version: int = 0, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.has_res_conv = in_channels != out_channels
        if self.has_res_conv:
            self.res_conv = nn.Linear(in_channels, out_channels)
            self.res_bn = BatchNormState(out_channels)
        self.gcn = GraphConv(time_dim, joints_dim, version)
        self.tcn_conv = nn.Linear(in_channels, out_channels)
        self.tcn_bn = BatchNormState(out_channels)
        self.prelu = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        res = (self.res_bn(self.res_conv(x), train)
               if self.has_res_conv else x)
        h = dropout(self.tcn_bn(self.tcn_conv(self.gcn(x)), train),
                    self.dropout, train, generator)
        h = h + res
        return torch.where(h >= 0, h, self.prelu * h)
