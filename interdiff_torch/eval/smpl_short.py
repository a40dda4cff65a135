"""SMPL-track short-term sampler (`interdiff_tpu/eval/smpl_short.py`):
reverse diffusion with past-frame inpainting, conditioned on the memory of
`MDMSmpl.encode`.

This slice ports the sampler without correction.  The physics-informed
correction in the loop (`make_correction_denoised_fn`), the DDIM and PLMS
samplers and `postprocess_sample` (SMPL forward kinematics) come with later
slices, and asking for them raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
import torch

from interdiff_torch.diffusion.gaussian import GaussianDiffusion, Inpaint
from interdiff_torch.geometry.rotations import (
    matrix_to_axis_angle,
    rotation_6d_to_matrix,
)
from interdiff_torch.models.mdm_smpl import MDMSmpl


@dataclass(frozen=True)
class SmplEvalConfig:
    past_len: int = 10
    future_len: int = 25
    smpl_dim: int = 132

    @property
    def seq_len(self) -> int:
        return self.past_len + self.future_len


def pad_idx(cfg: SmplEvalConfig) -> np.ndarray:
    return np.concatenate([np.arange(cfg.past_len),
                           np.full(cfg.future_len, cfg.past_len - 1)])


def make_sampler(cfg: SmplEvalConfig, model: MDMSmpl,
                 diffusion: GaussianDiffusion, *,
                 use_correction: bool = False, reuse_memory: bool = False,
                 sampler: str = "ddpm") -> Callable:
    """Build ``sample(gt, obj_points6, hand_pose, betas, *, noise=None,
    step_noise=None, generator=None) -> x [B,T,144]``
    (`eval_smpl_short.py:133-215`).

    ``reuse_memory=True`` adds a ``memory`` argument after ``betas``: the
    conditioning encoder is deterministic, so best-of-N evaluation encodes
    once and shares the memory across the diverse samples.  ``noise``
    [B,T,144] is the initial sample and ``step_noise`` [steps, B,T,144] the
    per-step draws; what is not given is drawn from ``generator``.
    ``hand_pose`` and ``betas`` feed the correction only.
    """
    if use_correction:
        raise NotImplementedError(
            "correction in the sampling loop comes with slice 2 of the port")
    if sampler != "ddpm":
        raise NotImplementedError(
            f"the {sampler!r} sampler comes with a later slice of the port; "
            "slice 1 has 'ddpm'")
    # tie selection in the ball query and parity with the reference need
    # full-f32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def _run(gt, obj_points6, hand_pose, betas, memory, *, noise=None,
             step_noise=None, generator=None):
        mask = torch.zeros_like(gt, dtype=torch.bool)
        mask[:, : cfg.past_len] = True
        if noise is None:
            noise = torch.randn(gt.shape, generator=generator,
                                device=gt.device, dtype=gt.dtype)
        return diffusion.p_sample_loop(
            lambda x, ts: model.denoise(x, ts, memory), noise=noise,
            step_noise=step_noise, generator=generator,
            inpaint=Inpaint(mask, gt))

    if reuse_memory:
        return _run

    def sample(gt, obj_points6, hand_pose, betas, *, noise=None,
               step_noise=None, generator=None):
        memory = model.encode(gt, obj_points6)
        return _run(gt, obj_points6, hand_pose, betas, memory, noise=noise,
                    step_noise=step_noise, generator=generator)

    return sample


def state_to_axis_angle(cfg: SmplEvalConfig, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """State [B,T,144] -> (body aa + trans [B,T,69], obj aa + trans
    [B,T,6]), without FK or hand padding (`train_diffusion_smpl.py:185-260`)."""
    B, T = x.shape[:2]
    D = cfg.smpl_dim + 3
    body, obj = x[..., :D], x[..., D:]
    body_aa = matrix_to_axis_angle(rotation_6d_to_matrix(
        body[..., :-3].reshape(B, T, -1, 6))).reshape(B, T, -1)
    obj_aa = matrix_to_axis_angle(rotation_6d_to_matrix(obj[..., :6]))
    return (torch.cat([body_aa, body[..., -3:]], dim=-1),
            torch.cat([obj_aa, obj[..., -3:]], dim=-1))
