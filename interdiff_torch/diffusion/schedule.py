"""Beta schedules and timestep respacing (a copy of
`interdiff_tpu/diffusion/schedule.py`, which is numpy only).

Numerics match the reference DDPM engine exactly: schedules are computed in
float64 (`interdiff/diffusion/gaussian_diffusion.py:20-64,160-199`) and the
respacing rule follows `interdiff/diffusion/respace.py:8-87` (including the
"ddimN" striding special case and the rescaled betas over kept steps).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int,
                            scale_betas: float = 1.0) -> np.ndarray:
    """'linear' (Ho et al., step-count invariant) or 'cosine' (Nichol & Dhariwal)."""
    if schedule_name == "linear":
        scale = scale_betas * 1000 / num_diffusion_timesteps
        return np.linspace(scale * 0.0001, scale * 0.02, num_diffusion_timesteps,
                           dtype=np.float64)
    if schedule_name == "cosine":
        return betas_for_alpha_bar(
            num_diffusion_timesteps,
            lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2,
        )
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def betas_for_alpha_bar(num_diffusion_timesteps: int, alpha_bar,
                        max_beta: float = 0.999) -> np.ndarray:
    """Discretise a continuous alpha-bar function into betas."""
    betas = []
    for i in range(num_diffusion_timesteps):
        t1 = i / num_diffusion_timesteps
        t2 = (i + 1) / num_diffusion_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def space_timesteps(num_timesteps: int, section_counts) -> set[int]:
    """Pick a subset of timesteps to keep; see `interdiff/diffusion/respace.py:8-61`.

    ``section_counts`` may be a list of per-section step counts, a
    comma-separated string, or "ddimN" for DDIM striding.
    """
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired_count = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired_count:
                    return set(range(0, num_timesteps, i))
            raise ValueError(
                f"cannot create exactly {desired_count} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps: list[int] = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(
                f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        taken_steps = []
        for _ in range(section_count):
            taken_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        all_steps += taken_steps
        start_idx += size
    return set(all_steps)


def respace_betas(betas: np.ndarray, use_timesteps: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    """Rescale betas over the kept timesteps.

    Returns ``(new_betas, timestep_map)`` where ``timestep_map[i]`` is the
    original timestep that respaced index ``i`` refers to — the model is fed
    ``timestep_map[t]`` (`interdiff/diffusion/respace.py:117-129`).
    """
    use = set(int(t) for t in use_timesteps)
    alphas_cumprod = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    last_alpha_cumprod = 1.0
    new_betas, timestep_map = [], []
    for i, ac in enumerate(alphas_cumprod):
        if i in use:
            new_betas.append(1 - ac / last_alpha_cumprod)
            last_alpha_cumprod = ac
            timestep_map.append(i)
    return np.array(new_betas, dtype=np.float64), np.array(timestep_map, dtype=np.int32)
