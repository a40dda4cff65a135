"""MDM's text-to-motion denoiser (Tevet et al., ICLR 2023;
github.com/GuyTevet/motion-diffusion-model `model/mdm.py` with
``arch='trans_enc'`` and `model/cfg_sampler.py`), batch-first.

State [B, frames, 263]: HumanML3D's features a frame.  The condition is
CLIP's pooled text (`models/clip_text.py`, the submodule ``clip``), encoded
once a batch by :meth:`MDMText.encode_text`.  A denoiser call embeds
``emb = TE(t) + L_text(c)`` as the first token, the frames through
``L_pose`` after it, adds the sinusoidal positions, runs the post-norm
encoder (no padding mask, as the source's ``trans_enc`` passes none; on
the card each layer's attention is one packed QKV product and kernel K7,
`models/layers.py::PackedEncoderLayer`) and maps every frame token but
the first through ``L_final`` to x0.  The null
condition is ``c = 0``, so a null row still carries ``L_text``'s bias (the
source's ``mask_cond`` under ``force_mask``).

Classifier-free guidance (``scale`` given) is one call of 2B rows, the
conditioned half first and the null half after it, combined as
``x0_null + s (x0_cond - x0_null)`` with ``s`` a row: one call a step, so
the call replays one CUDA graph (`models/denoise_graph.py`).  Dropout and
``cond_mask_prob`` act with ``train=True`` only.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from interdiff_torch import resolve_device
from interdiff_torch.models.clip_text import CLIPTextEncoder
from interdiff_torch.models.denoise_graph import GraphedDenoiser
from interdiff_torch.models.layers import (
    PositionalEncoding,
    TimestepEmbedder,
    TransformerStack,
)
from interdiff_torch.utils import profiling


class MDMText(GraphedDenoiser):
    """MDM (``trans_enc``) with its CLIP text tower, at the source's
    HumanML3D defaults: 263 features, latent 512, 4 heads, ff 1024, 8
    layers, gelu, dropout 0.1, ``cond_mask_prob`` 0.1, CLIP ViT-B/32's
    tower (vocabulary 49408, context 77, 512 wide, 12 layers, 8 heads,
    512-wide output).  Built on ``device`` (CUDA unless given), in eval
    mode."""

    def __init__(self, njoints: int = 263, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 8,
                 num_heads: int = 4, dropout: float = 0.1,
                 activation: str = "gelu", cond_mask_prob: float = 0.1,
                 clip_dim: int = 512, vocab_size: int = 49408,
                 context_length: int = 77, transformer_width: int = 512,
                 transformer_layers: int = 12, transformer_heads: int = 8,
                 device=None):
        super().__init__()
        self.njoints = njoints
        self.cond_mask_prob = cond_mask_prob
        self.clip = CLIPTextEncoder(vocab_size, context_length,
                                    transformer_width, transformer_layers,
                                    transformer_heads, clip_dim)
        self.embed_text = nn.Linear(clip_dim, latent_dim)
        self.embed_timestep = TimestepEmbedder(latent_dim)
        self.input_process = nn.Linear(njoints, latent_dim)
        self.sequence_pos_encoder = PositionalEncoding(latent_dim, dropout)
        self.seqTransEncoder = TransformerStack(
            latent_dim, num_heads, ff_size, ("enc_packed",) * num_layers,
            activation, dropout)
        self.output_process = nn.Linear(latent_dim, njoints)
        self.to(resolve_device(device))
        self.eval()

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, context] -> CLIP's pooled text [B, clip_dim] (the
        source's ``encode_text``, run once a batch), in the span
        ``text.encode``; counters ``text.tokens`` (positions the tower
        runs) and ``text.live_tokens`` (positions up to and including each
        EOT)."""
        with profiling.span("text.encode", cuda=ids.is_cuda):
            text = self.clip(ids)
        if profiling.recording():
            profiling.count("text.tokens", ids.numel())
            profiling.count("text.live_tokens", (ids.argmax(-1) + 1).sum())
        return text

    def mask_cond(self, cond: torch.Tensor, *, force_mask: bool = False,
                  train: bool = False,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """`mdm.py::mask_cond`: zeros under ``force_mask``; in training with
        ``cond_mask_prob`` > 0 each row zeroed with that probability, drawn
        from ``generator``."""
        if force_mask:
            return torch.zeros_like(cond)
        if train and self.cond_mask_prob > 0.0:
            prob = torch.full((cond.shape[0], 1), self.cond_mask_prob,
                              dtype=cond.dtype, device=cond.device)
            return cond * (1.0 - torch.bernoulli(prob, generator=generator))
        return cond

    def denoise(self, x: torch.Tensor, timesteps: torch.Tensor,
                text: torch.Tensor, scale: Optional[torch.Tensor] = None, *,
                force_mask: bool = False, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One denoiser call: x [B, frames, njoints], timesteps [B], text
        [B, clip_dim] -> x0 [B, frames, njoints]; with ``scale`` [B] the
        guided x0 (module docstring), counted as ``guidance.calls``.

        Without a gradient, ``train`` and ``generator``, on CUDA, the call
        is replayed from a CUDA graph; either way no tensor handed in is
        written and none handed out is written again.  Counted as well:
        ``attention.layers`` (the encoder's layers) and
        ``attention.fused_layers`` (those whose attention K7 serves under
        this call's conditions, `PackedEncoderLayer.packed_path`)."""
        if scale is not None:
            profiling.count("guidance.calls", 1)
        if profiling.recording():
            stack = self.seqTransEncoder
            n = len(stack.kinds)
            profiling.count("attention.layers", n)
            profiling.count("attention.fused_layers",
                            n * stack.layer_0.packed_path(x, train))
        return self.replayed(self._denoise, (x, timesteps, text, scale),
                             train, generator, force_mask=force_mask)

    def _denoise(self, x, timesteps, text, scale=None, *, force_mask=False,
                 train=False, generator=None):
        """The eager body of :meth:`denoise`."""
        if scale is None:
            cond = self.mask_cond(text, force_mask=force_mask, train=train,
                                  generator=generator)
            return self._forward(x, timesteps, cond, train, generator)
        B = x.shape[0]
        out = self._forward(torch.cat([x, x]),
                            torch.cat([timesteps, timesteps]),
                            torch.cat([text, torch.zeros_like(text)]),
                            train, generator)
        cond, null = out[:B], out[B:]
        return null + scale[:, None, None] * (cond - null)

    def _forward(self, x, timesteps, cond, train, generator):
        emb = self.embed_timestep(timesteps) + self.embed_text(cond)[:, None]
        h = torch.cat([emb, self.input_process(x)], dim=1)
        h = self.sequence_pos_encoder(h, train, generator)
        h = self.seqTransEncoder(h, train=train, generator=generator)
        return self.output_process(h[:, 1:])
