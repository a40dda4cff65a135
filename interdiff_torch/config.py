"""Typed configuration of the SMPL track (`interdiff_tpu/config.py:16-68`).

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
class CorrectionConfig:
    """`train_correction_smpl.py:286-330` / `correction.ckpt` hparams, SMPL
    track (the skeleton-track projector is not ported yet)."""

    num_nodes: int = 67  # markers
    dct: int = 10  # n_pre, the kept DCT coefficients
    past_len: int = 10
    future_len: int = 25

    def build_model(self, device=None):
        from interdiff_torch.models.correction import ObjProjectorSmpl

        return ObjProjectorSmpl(
            num_markers=self.num_nodes, n_pre=self.dct,
            past_len=self.past_len, future_len=self.future_len,
            device=device)


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
