"""The cosine-schedule DDPM of both tracks: the schedule in float64, cast
once to float32, and one ancestral step that predicts x0, inpaints the
past, applies the correction hook and samples the posterior."""

from __future__ import annotations

import math

import numpy as np
import torch


def betas(steps: int) -> np.ndarray:
    """The cosine schedule's betas, float64."""
    def abar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    return np.array([min(1 - abar((i + 1) / steps) / abar(i / steps), 0.999)
                     for i in range(steps)], dtype=np.float64)


def cosine_schedule(steps: int) -> dict:
    b = betas(steps)
    ac = np.cumprod(1.0 - b)
    prev = np.append(1.0, ac[:-1])
    var = b * (1.0 - prev) / (1.0 - ac)
    out = {
        "coef1": b * np.sqrt(prev) / (1.0 - ac),
        "coef2": (1.0 - prev) * np.sqrt(1.0 - b) / (1.0 - ac),
        "sqrt_ac": np.sqrt(ac), "sqrt_1mac": np.sqrt(1.0 - ac),
        "log_var": np.log(np.append(var[1], var[1:])),
    }
    return {k: v.astype(np.float32) for k, v in out.items()}


def fires(cfg: dict, t: int) -> bool:
    """Whether the correction hook acts at step t: at t <= the
    configuration's ``correction_t_max``, every ``correction_every``."""
    return t <= cfg["correction_t_max"] and t % cfg["correction_every"] == 0


def step(sched: dict, x_t, t: int, x0, noise):
    """x_{t-1} from the (inpainted, corrected) x0 at step t."""
    c1 = float(sched["coef1"][t])
    c2 = float(sched["coef2"][t])
    mean = c1 * x0 + c2 * x_t
    if t == 0:
        return mean
    return mean + float(np.exp(np.float32(0.5) * sched["log_var"][t])) \
        * noise


def precision(name: str):
    """A context in which float32 products run in full float32 ("f32") or
    in TF32 ("tf32", the control)."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            on = name == "tf32"
            torch.backends.cuda.matmul.allow_tf32 = on
            torch.backends.cudnn.allow_tf32 = on

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.saved

    if name not in ("f32", "tf32"):
        raise ValueError(f"precision {name!r}")
    return _Ctx()
