"""Timestep schedule samplers (`interdiff_tpu/diffusion/resample.py`).

The practical configuration is uniform sampling; the loss-second-moment
importance sampler keeps, per timestep, a ring of the last
``history_per_term`` losses and samples timesteps in proportion to the root
mean square of each ring once every ring is full.

Its state is two small tensors (``loss_history`` [T, history] float32,
``loss_counts`` [T] int32) kept on the CPU: ``update`` folds a batch in one
``(t, loss)`` at a time, in order, so two equal ``t`` in a batch land as in
the JAX package's scan, and that sequential walk belongs on the host.  It
costs one read of the batch's ``t`` and losses per train step.  Draws take
an explicit `torch.Generator` and are made on that generator's device.
The all-gather across replicas (``axis_name``) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def _generator_device(generator: Optional[torch.Generator]) -> torch.device:
    return torch.device("cpu") if generator is None else generator.device


class UniformSampler:
    def __init__(self, num_timesteps: int):
        self.num_timesteps = num_timesteps

    def sample(self, generator: Optional[torch.Generator], batch_size: int,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """t ~ U{0..T-1} [batch] int64 and weights = 1, on ``device`` (the
        generator's when not given)."""
        if device is None:
            device = _generator_device(generator)
        t = torch.randint(0, self.num_timesteps, (batch_size,),
                          generator=generator, device=device)
        return t, torch.ones((batch_size,), dtype=torch.float32,
                             device=device)


@dataclass
class LossSecondMomentState:
    """Per-timestep loss history ring buffer plus fill counts, on the CPU."""

    loss_history: torch.Tensor  # [T, history_per_term] float32
    loss_counts: torch.Tensor  # [T] int32


class LossSecondMomentResampler:
    def __init__(self, num_timesteps: int, history_per_term: int = 10,
                 uniform_prob: float = 0.001):
        self.num_timesteps = num_timesteps
        self.history_per_term = history_per_term
        self.uniform_prob = uniform_prob

    def init_state(self) -> LossSecondMomentState:
        return LossSecondMomentState(
            loss_history=torch.zeros(
                (self.num_timesteps, self.history_per_term),
                dtype=torch.float32),
            loss_counts=torch.zeros((self.num_timesteps,),
                                    dtype=torch.int32))

    def weights(self, state: LossSecondMomentState) -> torch.Tensor:
        """Sampling probabilities [T]: uniform until every ring is full."""
        T = self.num_timesteps
        if not bool((state.loss_counts == self.history_per_term).all()):
            return torch.full((T,), 1.0 / T, dtype=torch.float32)
        sq_mean = torch.sqrt((state.loss_history ** 2).mean(dim=-1))
        w = sq_mean / sq_mean.sum().clamp(min=1e-12)
        return w * (1 - self.uniform_prob) + self.uniform_prob / T

    def importance_weights(self, state: LossSecondMomentState,
                           t: torch.Tensor) -> torch.Tensor:
        """The loss weights 1 / (T * p[t]) of given timesteps, on ``t``'s
        device."""
        p = self.weights(state).to(t.device)
        return (1.0 / (self.num_timesteps * p[t])).to(torch.float32)

    def sample(self, generator: Optional[torch.Generator], batch_size: int,
               state: LossSecondMomentState
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """t ~ p [batch] int64 and the weights 1 / (T * p[t]), on the
        generator's device."""
        p = self.weights(state).to(_generator_device(generator))
        t = torch.multinomial(p, batch_size, replacement=True,
                              generator=generator)
        return t, (1.0 / (self.num_timesteps * p[t])).to(torch.float32)

    def update(self, state: LossSecondMomentState, ts: torch.Tensor,
               losses: torch.Tensor) -> LossSecondMomentState:
        """Fold a batch of (t, loss) pairs into the history, in order:
        append while a ring has room, else drop its oldest entry.  Returns
        a new state; the old one is left as it was."""
        hist = state.loss_history.clone()
        counts = state.loss_counts.clone()
        H = self.history_per_term
        for t, loss in zip(ts.detach().cpu().tolist(),
                           losses.detach().to(torch.float32).cpu().tolist()):
            cnt = int(counts[t])
            if cnt == H:
                hist[t, :-1] = hist[t, 1:].clone()
                hist[t, -1] = loss
            else:
                hist[t, cnt] = loss
                counts[t] = cnt + 1
        return LossSecondMomentState(hist, counts)


def create_named_schedule_sampler(name: str, num_timesteps: int):
    if name == "uniform":
        return UniformSampler(num_timesteps)
    if name == "loss-second-moment":
        return LossSecondMomentResampler(num_timesteps)
    raise NotImplementedError(f"unknown schedule sampler: {name}")
