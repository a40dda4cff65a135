"""The SMPL-track diffusion train step (`interdiff_tpu/train/trainer.py`):
AdamW, the timestep samplers, the EMA shadow and the two BatchNorm modes of
the PointNet++ encoder.

Where the JAX package threads an immutable `TrainState` through a jitted
function, the port updates in place: the parameters live in the `MDMSmpl`
module, ``state.params`` names them, the optimiser steps them, and a step
returns the same state object with its counter advanced.  The skeleton and
correction steps and the data-parallel wrapper (`data_parallel_step`) are
not ported yet.

BatchNorm modes.  Default: the encoder's BatchNorms normalise with their
running statistics, which are parameters, are differentiated and are stepped
by the optimiser (and covered by the EMA shadow), as in the JAX package,
where ``batch_stats`` sit inside the optimised tree.  ``bn_train_mode``
(the reference's Lightning semantics): batch statistics normalise, the
running statistics move by momentum and stay out of the optimiser;
:func:`split_bn_state` takes them out.

The denoiser runs as `MDMSmpl` is built, in eval mode, as the JAX step runs
it (``train=False``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from interdiff_torch.diffusion.gaussian import GaussianDiffusion
from interdiff_torch.diffusion.nn import update_ema
from interdiff_torch.diffusion.resample import (
    LossSecondMomentResampler,
    UniformSampler,
)
from interdiff_torch.models.mdm_smpl import MDMSmpl, smpl_gt_from_raw
from interdiff_torch.train.losses import SmplLossWeights, smpl_diffusion_losses
from interdiff_torch.utils.train_io import quartile_metrics

Params = Dict[str, torch.Tensor]
_BN_STATS = ("running_mean", "running_var")


def adamw(lr: float = 3e-4, weight_decay: float = 0.0
          ) -> Callable[[Any], torch.optim.Optimizer]:
    """AdamW with the reference defaults (`train_diffusion_smpl.py:177-183`,
    lr 3e-4, l2_norm 0) as ``tx(parameters) -> optimiser``: betas 0.9 and
    0.999, eps 1e-8 and **no weight decay**, the values of
    `optax.adamw(lr, weight_decay=0.0)` (`torch.optim.AdamW` alone would
    decay by 0.01).  The ``foreach`` implementation: one fused pass per
    moment instead of several launches per parameter."""
    def tx(parameters) -> torch.optim.Optimizer:
        return torch.optim.AdamW(parameters, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=weight_decay,
                                 foreach=True)
    return tx


@dataclass
class TrainState:
    """Step counter, the module's optimised parameters by name, the
    optimiser over them, and optionally the schedule sampler's state, the
    EMA shadow (a distinct copy, by the same names) and, under
    ``bn_train_mode``, the BatchNorm running statistics that the optimiser
    does not see."""

    step: int
    params: Params
    optimizer: torch.optim.Optimizer
    sampler_state: Any = None
    ema_params: Optional[Params] = None
    ema_rate: float = 0.0
    model_state: Optional[Params] = None

    @classmethod
    def create(cls, params: Params, tx, *, sampler_state=None,
               ema_rate: float = 0.0, model_state: Optional[Params] = None
               ) -> "TrainState":
        ema = ({k: v.detach().clone() for k, v in params.items()}
               if ema_rate > 0.0 else None)
        return cls(step=0, params=params, optimizer=tx(list(params.values())),
                   sampler_state=sampler_state, ema_params=ema,
                   ema_rate=ema_rate, model_state=model_state)

    def apply_gradients(self) -> "TrainState":
        """One optimiser step on the gradients the parameters hold, then
        the EMA update."""
        self.optimizer.step()
        if self.ema_params is not None:
            update_ema(self.ema_params, self.params, rate=self.ema_rate)
        self.step += 1
        return self


def sample_timesteps(generator: Optional[torch.Generator], batch: int,
                     num_timesteps: int, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`UniformSampler`: t ~ U [batch] int64, weights = 1, on ``device``
    (the generator's when not given)."""
    return UniformSampler(num_timesteps).sample(generator, batch, device)


def smpl_cond_inputs(batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch dict -> (gt state [B,T,144], obj_points [B,P,6])."""
    gt = smpl_gt_from_raw(batch["body_pose"][..., :66], batch["body_trans"],
                          batch["obj_angles"], batch["obj_trans"])
    return gt, batch["obj_points"]


def split_bn_state(model: torch.nn.Module) -> Tuple[Params, Params]:
    """The module's parameters as (trainable, model_state): the BatchNorm
    running statistics go to ``model_state`` and stop requiring a gradient.
    Use with ``make_smpl_train_step(bn_train_mode=True)`` and
    ``TrainState.create(trainable, tx, model_state=ms)``."""
    params, model_state = {}, {}
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in _BN_STATS:
            model_state[name] = p.requires_grad_(False)
        else:
            params[name] = p
    return params, model_state


def merge_bn_state(params: Params, model_state: Optional[Params]) -> Params:
    """Recombine the split state into one name -> tensor mapping, the layout
    of a state dict (validation, sampling, checkpoint save)."""
    return {**params, **(model_state or {})}


def make_smpl_train_step(
    model: MDMSmpl, diffusion: GaussianDiffusion, *,
    weights: SmplLossWeights = SmplLossWeights(),
    schedule_sampler: Union[str, LossSecondMomentResampler] = "uniform",
    bn_train_mode: bool = False,
) -> Callable:
    """Returns ``step(state, batch, generator=None, *, t=None, noise=None)
    -> (state, metrics)`` on the model's device.

    ``state`` is a `TrainState` over ``model``'s parameters.  ``batch`` holds
    tensors ``body_pose`` [B,T,>=66], ``body_trans``, ``obj_angles``,
    ``obj_trans`` [B,T,3] and ``obj_points`` [B,P,6].  The timesteps and the
    noise are drawn from ``generator`` (a generator of the model's device)
    unless ``t`` [B] and ``noise`` [B,T,144] are given, which is how a test
    feeds this step and the JAX package's the same draws.

    ``schedule_sampler``: ``"uniform"``, ``"loss-second-moment"`` or a
    `LossSecondMomentResampler` (to control the history size); the
    loss-aware variant needs ``state.sampler_state`` from the same
    resampler's ``init_state()``, and the step folds the batch's per-sample
    losses into it.

    ``metrics``: ``loss``, the 16 weighted terms as batch means and
    ``loss_q0..3`` (the per-sample loss by timestep quartile), 0-d tensors
    on the device; nothing is read back here.  After the step each
    parameter's ``.grad`` holds this step's gradient.
    """
    resampler = None
    if isinstance(schedule_sampler, LossSecondMomentResampler):
        resampler = schedule_sampler
    elif schedule_sampler == "loss-second-moment":
        resampler = LossSecondMomentResampler(diffusion.num_timesteps)
    elif schedule_sampler != "uniform":
        raise ValueError(f"unknown schedule sampler: {schedule_sampler}")

    def step(state: TrainState, batch, generator=None, *, t=None,
             noise=None):
        if resampler is not None and state.sampler_state is None:
            raise ValueError(
                "schedule_sampler is loss-aware but TrainState.sampler_state "
                "is None: create the state with TrainState.create(params, "
                "tx, sampler_state=resampler.init_state()) using the SAME "
                "resampler (the history width is part of the state)")
        if bn_train_mode and state.model_state is None:
            raise ValueError(
                "bn_train_mode=True needs TrainState.model_state: split "
                "the module's parameters with trainer.split_bn_state and "
                "pass model_state= to TrainState.create")
        gt, obj_points = smpl_cond_inputs(batch)
        B = gt.shape[0]
        memory = model.encode(gt, obj_points, train_encoder=bn_train_mode)
        if t is not None:
            sampler_w = (torch.ones((B,), dtype=torch.float32,
                                    device=gt.device) if resampler is None
                         else resampler.importance_weights(
                             state.sampler_state, t))
        elif resampler is None:
            t, sampler_w = sample_timesteps(generator, B,
                                            diffusion.num_timesteps,
                                            gt.device)
        else:
            t, sampler_w = resampler.sample(generator, B,
                                            state.sampler_state)
            t, sampler_w = t.to(gt.device), sampler_w.to(gt.device)
        if noise is None:
            noise = torch.randn(gt.shape, generator=generator,
                                device=gt.device, dtype=gt.dtype)

        def model_fn(x, ts):
            return model.denoise(x, ts, memory)

        pred, target = diffusion.training_losses(model_fn, gt, t, noise=noise)
        per_sample, terms = smpl_diffusion_losses(
            pred, target, past_len=model.past_len, smpl_dim=model.smpl_dim,
            weights=weights)
        loss = (per_sample * sampler_w).mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()

        per_sample = per_sample.detach()
        metrics = {k: v.detach().mean() for k, v in terms.items()}
        metrics["loss"] = loss.detach()
        for q, v in quartile_metrics(t, per_sample,
                                     diffusion.num_timesteps).items():
            metrics[f"loss_{q}"] = v
        if resampler is not None:
            state.sampler_state = resampler.update(state.sampler_state, t,
                                                   per_sample)
        return state, metrics

    return step


def chain_steps(step_fn: Callable) -> Callable:
    """Wrap ``step(state, batch, generator, ...)`` into
    ``step_many(state, stacked_batch, generator, *, t=None, noise=None)``:
    one optimiser step per slice of the leading axis of ``stacked_batch``
    (and of ``t`` and ``noise`` where given), in order; metrics come back
    stacked [K].  The JAX package scans the K steps inside one dispatch; in
    eager PyTorch the same K sequential steps are a loop."""

    def step_many(state, stacked_batch, generator=None, *, t=None,
                  noise=None):
        k = next(iter(stacked_batch.values())).shape[0]
        rows = []
        for i in range(k):
            state, metrics = step_fn(
                state, {name: v[i] for name, v in stacked_batch.items()},
                generator, t=None if t is None else t[i],
                noise=None if noise is None else noise[i])
            rows.append(metrics)
        return state, {name: torch.stack([m[name] for m in rows])
                       for name in rows[0]}

    return step_many
