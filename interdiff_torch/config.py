"""Typed configuration of both tracks (`interdiff_tpu/config.py:16-123`)
and of MDM's text-to-motion model (``TextTrackConfig``, no JAX
counterpart).

The defaults are the reference's training-time values; ``build``,
``build_model`` and ``build_smpl_body`` return the port's objects on
``device`` (CUDA unless given).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DiffusionConfig:
    """`create_gaussian_diffusion` (`model/diffusion_smpl.py:251-284`)."""

    noise_schedule: str = "cosine"
    diffusion_steps: int = 1000
    timestep_respacing: str = ""  # e.g. "100"
    sigma_small: bool = True
    predict_xstart: bool = True
    rescale_timesteps: bool = False

    def build(self, device=None):
        from interdiff_torch.diffusion.gaussian import GaussianDiffusion

        return GaussianDiffusion.create_named(
            schedule_name=self.noise_schedule, steps=self.diffusion_steps,
            timestep_respacing=self.timestep_respacing or None,
            predict_xstart=self.predict_xstart, sigma_small=self.sigma_small,
            rescale_timesteps=self.rescale_timesteps, device=device)


@dataclass(frozen=True)
class SmplTrackConfig:
    """`train_diffusion_smpl.py:538-604` defaults."""

    smpl_dim: int = 132
    embedding_dim: int = 256
    num_heads: int = 4
    ff_size: int = 1024
    activation: str = "gelu"
    dropout: float = 0.0
    num_layers: int = 8
    latent_usage: str = "memory"
    use_pointnet2: bool = True
    # 1 = exact furthest_point_sample order; >1 = grouped-parallel FPS
    fps_groups: int = 16
    past_len: int = 10
    future_len: int = 25
    cond_mask_prob: float = 0.0
    diffusion: DiffusionConfig = DiffusionConfig()

    def build_model(self, device=None):
        from interdiff_torch.models.mdm_smpl import MDMSmpl

        return MDMSmpl(
            smpl_dim=self.smpl_dim, embed_dim=self.embedding_dim,
            num_heads=self.num_heads, ff_size=self.ff_size,
            num_layers=self.num_layers, dropout=self.dropout,
            activation=self.activation, past_len=self.past_len,
            future_len=self.future_len, cond_mask_prob=self.cond_mask_prob,
            latent_usage=self.latent_usage,
            use_pointnet2=self.use_pointnet2, fps_groups=self.fps_groups,
            device=device)


@dataclass(frozen=True)
class SkeletonTrackConfig:
    """`train_diffusion_skeleton.py:354-383` defaults (ff 256)."""

    num_joints: int = 21
    num_points: int = 12
    embedding_dim: int = 256
    num_heads: int = 4
    ff_size: int = 256
    activation: str = "gelu"
    dropout: float = 0.0
    num_layers: int = 8
    latent_usage: str = "memory"
    past_len: int = 10
    future_len: int = 25  # train default; eval ckpts use 10
    cond_mask_prob: float = 0.0
    diffusion: DiffusionConfig = DiffusionConfig()

    def build_model(self, device=None):
        from interdiff_torch.models.mdm_skeleton import MDMSkeleton

        return MDMSkeleton(
            num_joints=self.num_joints, num_points=self.num_points,
            embed_dim=self.embedding_dim, num_heads=self.num_heads,
            ff_size=self.ff_size, num_layers=self.num_layers,
            dropout=self.dropout, activation=self.activation,
            past_len=self.past_len, cond_mask_prob=self.cond_mask_prob,
            latent_usage=self.latent_usage, device=device)


@dataclass(frozen=True)
class TextTrackConfig:
    """MDM text-to-motion on HumanML3D (github.com/GuyTevet/
    motion-diffusion-model `utils/parser_util.py` defaults with
    ``arch='trans_enc'``, `model/mdm.py`) and CLIP ViT-B/32's text tower
    (`clip/model.py`)."""

    njoints: int = 263  # HumanML3D's features a frame
    latent_dim: int = 512
    ff_size: int = 1024
    num_layers: int = 8
    num_heads: int = 4
    dropout: float = 0.1
    activation: str = "gelu"
    cond_mask_prob: float = 0.1
    clip_dim: int = 512
    vocab_size: int = 49408
    context_length: int = 77
    transformer_width: int = 512
    transformer_layers: int = 12
    transformer_heads: int = 8
    diffusion: DiffusionConfig = DiffusionConfig()

    def build_model(self, device=None):
        from interdiff_torch.models.mdm_text import MDMText

        return MDMText(
            njoints=self.njoints, latent_dim=self.latent_dim,
            ff_size=self.ff_size, num_layers=self.num_layers,
            num_heads=self.num_heads, dropout=self.dropout,
            activation=self.activation, cond_mask_prob=self.cond_mask_prob,
            clip_dim=self.clip_dim, vocab_size=self.vocab_size,
            context_length=self.context_length,
            transformer_width=self.transformer_width,
            transformer_layers=self.transformer_layers,
            transformer_heads=self.transformer_heads, device=device)


@dataclass(frozen=True)
class CorrectionConfig:
    """`train_correction_smpl.py:286-330` / `correction.ckpt` hparams."""

    track: str = "smpl"  # or "skeleton"
    num_nodes: int = 67  # markers (smpl) / joints (skeleton)
    dct: int = 10  # n_pre, the kept DCT coefficients; skeleton hardcodes 20
    past_len: int = 10
    future_len: int = 25  # skeleton: 10

    def build_model(self, device=None):
        from interdiff_torch.models.correction import (
            ObjProjectorSkeleton,
            ObjProjectorSmpl,
        )

        if self.track == "smpl":
            return ObjProjectorSmpl(
                num_markers=self.num_nodes, n_pre=self.dct,
                past_len=self.past_len, future_len=self.future_len,
                device=device)
        return ObjProjectorSkeleton(
            num_joints=self.num_nodes, past_len=self.past_len,
            future_len=self.future_len, device=device)


def build_smpl_body(arrays=None, *, seed: int = 0, num_verts: int = 6890,
                    num_joints: int = 52, device=None):
    """The body model on ``device``: from ``arrays`` (the keyword arguments
    of `SmplModel.create`, e.g. read from an SMPL-H pkl) or, without them,
    the closed stand-in body at SMPL-H's sizes made from ``seed``."""
    from interdiff_torch.smpl.model import SmplModel

    if arrays is not None:
        return SmplModel.create(**arrays, device=device)
    import numpy as np

    from interdiff_torch.cli.common import synthetic_smpl_body

    return synthetic_smpl_body(np.random.default_rng(seed),
                               num_verts=num_verts, num_joints=num_joints,
                               device=device)
