"""CLIP's text tower (Radford et al. 2021; github.com/openai/CLIP
`clip/model.py`, `CLIP.encode_text`), the text encoder of MDM's
text-to-motion model, batch-first [B, T, D].

``x = E_tok[ids] + P[:T]``, then ``layers`` pre-norm layers, each
``x = x + Attn(LN1(x), causal)`` and ``x = x + W2 QuickGELU(W1 LN2(x))``,
then ``LN_final`` and the row of the EOT token (the largest id,
``argmax(ids)``) through ``W_proj`` (no bias).  Attention is the port's
`TorchMHA` (packed ``in_proj_kernel``, an output projection with bias)
under the additive causal mask.  Names follow the port's layers
(``layer_<i>.norm1``, ``.self_attn``, ``.norm2``, ``.ff.linear1``, ...); the
embeddings are ``nn.Embedding``s and ``W_proj`` a bias-free ``nn.Linear``
(its ``weight`` is CLIP's ``text_projection`` transposed).  Everything
runs in float32: MDM casts the tower to float16, the port does not.
"""

from __future__ import annotations

import torch
from torch import nn

from interdiff_torch.models.layers import FeedForward, TorchMHA
from interdiff_torch.ops.attention import causal_mask


class PreNormEncoderLayer(nn.Module):
    """CLIP's ``ResidualAttentionBlock``: pre-norm, causal self-attention
    and a QuickGELU MLP, each added to the residual stream."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.self_attn = TorchMHA(d_model, num_heads)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.ff = FeedForward(d_model, dim_feedforward, "quick_gelu")

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h, h, mask)
        return x + self.ff(self.norm2(x))


class CLIPTextEncoder(nn.Module):
    """ids [B, context_length] (SOT, tokens, EOT, zeros) -> the pooled text
    [B, embed_dim].  The MLP is 4 x ``width`` wide, as in CLIP."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 embed_dim: int = 512):
        super().__init__()
        self.num_layers = layers
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.position_embedding = nn.Embedding(context_length, width)
        for i in range(layers):
            self.add_module(f"layer_{i}",
                            PreNormEncoderLayer(width, heads, 4 * width))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Linear(width, embed_dim, bias=False)
        self.register_buffer("mask", causal_mask(context_length),
                             persistent=False)

    def hidden(self, ids: torch.Tensor) -> torch.Tensor:
        """``LN_final`` of the last layer's output, every position
        [B, T, width]."""
        T = ids.shape[1]
        x = self.token_embedding(ids) + self.position_embedding.weight[:T]
        mask = self.mask[:T, :T]
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return self.ln_final(x)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        h = self.hidden(ids)
        eot = h[torch.arange(ids.shape[0], device=ids.device),
                ids.argmax(dim=-1)]
        return self.text_projection(eot)
