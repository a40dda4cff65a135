"""MDM text-to-motion sampling (github.com/GuyTevet/motion-diffusion-model
`sample/generate.py` and `eval/eval_humanml.py`): caption ids in CLIP's
layout, the text tower once a batch, and the guided DDPM over the whole
motion, every frame sampled (no inpainting, no hook).

The ids are HumanML3D's layout of MDM's ``encode_text``: SOT, at most 20
BPE tokens, EOT, zeros up to the context; SOT and EOT are the vocabulary's
last two ids (49406 and 49407 in CLIP's).  The BPE tokenizer itself is
not part of the port: callers hand in token ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from interdiff_torch import full_f32
from interdiff_torch.diffusion.gaussian import GaussianDiffusion
from interdiff_torch.models.mdm_text import MDMText
from interdiff_torch.parallel.mesh import randn_rows

MAX_TOKENS = 20  # MDM's ``max_text_len`` for HumanML3D


@dataclass(frozen=True)
class TextEvalConfig:
    num_frames: int = 196  # HumanML3D's longest motion, MDM's eval length
    num_joints: int = 22
    guidance_param: float = 2.5  # MDM's classifier-free scale


def caption_ids(tokens: Sequence[Sequence[int]], *, vocab_size: int = 49408,
                context_length: int = 77) -> np.ndarray:
    """[len(tokens), context_length] int64: SOT, the first
    :data:`MAX_TOKENS` tokens of each caption, EOT, zeros (CLIP's
    ``tokenize(..., context_length=22, truncate=True)`` padded to the
    context, as MDM does)."""
    sot, eot = vocab_size - 2, vocab_size - 1
    out = np.zeros((len(tokens), context_length), dtype=np.int64)
    for i, t in enumerate(tokens):
        t = [int(v) for v in t][:MAX_TOKENS]
        if any(not 0 < v < sot for v in t):
            raise ValueError(f"caption {i}: token ids must lie in "
                             f"[1, {sot - 1}]")
        out[i, :len(t) + 2] = [sot, *t, eot]
    return out


def make_text_sampler(cfg: TextEvalConfig, model: MDMText,
                      diffusion: GaussianDiffusion) -> Callable:
    """``sample(text, *, noise=None, step_noise=None, generator=None) -> x
    [B, num_frames, njoints]``: the DDPM loop on the guided denoiser, every
    row at ``cfg.guidance_param``.  ``noise`` is the initial sample and
    ``step_noise`` [steps, B, num_frames, njoints] the per-step draws; what
    is not given is drawn from ``generator``."""
    full_f32()

    @torch.no_grad()
    def sample(text: torch.Tensor, *, noise: Optional[torch.Tensor] = None,
               step_noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B = text.shape[0]
        shape = (B, cfg.num_frames, model.njoints)
        if noise is None:
            noise = randn_rows(shape, generator, text.device, text.dtype)
        scale = torch.full((B,), cfg.guidance_param, dtype=text.dtype,
                           device=text.device)

        def model_fn(x, ts):
            return model.denoise(x, ts, text, scale)

        return diffusion.sample_loop("ddpm", model_fn, noise=noise,
                                     step_noise=step_noise,
                                     generator=generator)

    return sample


def motion_stats(joints: torch.Tensor) -> dict:
    """Two plain statistics of joints [B, frames, J, 3], 0-d tensors:
    ``root_travel``, the mean distance in x/z from the root's first frame
    to its last (m); ``joint_speed``, the mean displacement of a joint
    from one frame to the next (m)."""
    root = joints[:, :, 0]
    return {
        "root_travel": torch.linalg.norm(
            (root[:, -1] - root[:, 0])[:, [0, 2]], dim=-1).mean(),
        "joint_speed": torch.linalg.norm(
            joints[:, 1:] - joints[:, :-1], dim=-1).mean(),
    }
