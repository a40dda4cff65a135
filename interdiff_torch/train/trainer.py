"""The train steps of both tracks (`interdiff_tpu/train/trainer.py`): the
diffusion steps with AdamW, the timestep samplers, the EMA shadow and, on
the SMPL track, the two BatchNorm modes of the PointNet++ encoder; and the
correction networks' steps with Adam.

Where the JAX package threads an immutable `TrainState` through a jitted
function, the port updates in place: the parameters live in the `MDMSmpl`
module, ``state.params`` names them, the optimiser steps them, and a step
returns the same state object with its counter advanced.

Data parallelism (`data_parallel_step`, `interdiff_tpu/train/trainer.py:
422-448`): each rank steps its own rows of the global batch inside
`parallel/mesh.py::use_mesh`, where every step computes what the JAX
package's jitted step computes on the whole sharded batch.  The timesteps,
the noise and the SMPL projector's marker choice are drawn for the global
batch from the shared generator (seeded alike on every rank) and cut to the
rank's rows; each rank's loss is its share of the global mean (its local
mean / W: every term is a mean over rows, and the shards are equal); the
gradients are SUM all-reduced in one flattened buffer before the optimiser
(so with the BatchNorm all-reduce's backward they are the global batch's,
cross terms included); the metrics come back as global means and the
loss-second-moment resampler folds in every rank's pairs in row order.  The
optimiser, the EMA shadow and the resampler stay equal on every rank.

BatchNorm modes.  Default: the encoder's BatchNorms normalise with their
running statistics, which are parameters, are differentiated and are stepped
by the optimiser (and covered by the EMA shadow), as in the JAX package,
where ``batch_stats`` sit inside the optimised tree.  ``bn_train_mode``
(the reference's Lightning semantics): batch statistics normalise, the
running statistics move by momentum and stay out of the optimiser;
:func:`split_bn_state` takes them out.

The denoisers run as they are built, in eval mode, as the JAX steps run
them (``train=False``); a denoiser built with ``dropout`` or
``cond_mask_prob`` above 0 is refused, since neither would act.  The
correction projectors run in train mode: their BatchNorm running statistics
are buffers, moved by momentum in the forward (flax's
``mutable=["batch_stats"]``), and Adam sees only the parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from interdiff_torch import full_f32
from interdiff_torch.diffusion.gaussian import GaussianDiffusion
from interdiff_torch.diffusion.nn import update_ema
from interdiff_torch.diffusion.resample import (
    LossSecondMomentResampler,
    UniformSampler,
)
from interdiff_torch.geometry.rotations import (
    axis_angle_to_matrix,
    matrix_to_rotation_6d,
)
from interdiff_torch.models.correction import (
    ObjProjectorSkeleton,
    ObjProjectorSmpl,
)
from interdiff_torch.models.mdm_skeleton import MDMSkeleton
from interdiff_torch.models.mdm_smpl import MDMSmpl, smpl_gt_from_raw
from interdiff_torch.parallel.mesh import (
    DataMesh,
    active_mesh,
    all_reduce_grads,
    mean_metrics,
    randn_rows,
    shard_batch,
    use_mesh,
)
from interdiff_torch.train.losses import (
    SkeletonLossWeights,
    SmplLossWeights,
    skeleton_diffusion_losses,
    smpl_diffusion_losses,
)
from interdiff_torch.train.losses_correction import (
    CorrectionLossWeights,
    correction_skeleton_losses,
    correction_smpl_losses,
)
from interdiff_torch.utils.prefetch import place_batch
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


def _optimise(state, loss: torch.Tensor) -> None:
    """Backward and one optimiser step.  Under a data mesh of W ranks the
    rank's loss is its share of the global mean (loss / W) and the
    gradients are SUM all-reduced before the optimiser."""
    mesh = active_mesh()
    state.optimizer.zero_grad(set_to_none=True)
    if mesh is None:
        loss.backward()
    else:
        (loss / mesh.size).backward()
        all_reduce_grads(state.params.values(), mesh)
    state.apply_gradients()


def _metrics(terms: Dict[str, torch.Tensor], loss: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
    """The detached terms and ``loss``, as global means under a mesh."""
    metrics = {k: v.detach() for k, v in terms.items()}
    metrics["loss"] = loss.detach()
    return mean_metrics(metrics, active_mesh())


def sample_timesteps(generator: Optional[torch.Generator], batch: int,
                     num_timesteps: int, device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`UniformSampler`: t ~ U [batch] int64, weights = 1, on ``device``
    (the generator's when not given)."""
    return UniformSampler(num_timesteps).sample(generator, batch, device)


def _refuse_train_mode_rates(model) -> None:
    """The denoiser steps run ``model`` in eval mode, as the JAX steps do:
    its ``dropout`` and ``cond_mask_prob`` would not act, so a rate above 0
    is refused rather than ignored."""
    if model.dropout > 0.0 or model.cond_mask_prob > 0.0:
        raise ValueError(
            f"dropout={model.dropout}, cond_mask_prob={model.cond_mask_prob}"
            ": the train step runs the denoiser in eval mode (train=False, "
            "as the JAX package's does), where neither acts; build the "
            "model with both at 0")


def skeleton_gt_from_batch(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Batch dict -> state tensor [B, T, 106]."""
    B, T = batch["skeleton"].shape[:2]
    return torch.cat([batch["skeleton"].reshape(B, T, -1),
                      batch["obj_points"].reshape(B, T, -1),
                      batch["poses"]], dim=-1)


def make_skeleton_train_step(
    model: MDMSkeleton, diffusion: GaussianDiffusion, *,
    weights: SkeletonLossWeights = SkeletonLossWeights(),
) -> Callable:
    """Returns ``step(state, batch, generator=None, *, t=None, noise=None)
    -> (state, metrics)`` on the model's device.

    ``state`` is a `TrainState` over ``model``'s parameters; ``batch`` holds
    tensors ``skeleton`` [B,T,21,3], ``obj_points`` [B,T,12,3], ``poses``
    [B,T,7] and ``zero_pose_obj`` [B,12,3].  The encode runs
    deterministic; the timesteps (uniform) and the noise are drawn from
    ``generator`` unless ``t`` [B] and ``noise`` [B,T,106] are given.
    ``metrics``: ``loss`` and the 13 weighted terms, 0-d tensors on the
    device.  After the step each parameter's ``.grad`` holds this step's
    gradient.  TF32 is turned off: parity with the reference needs
    full-f32 matmuls.  A model with ``dropout`` or ``cond_mask_prob`` above
    0 is refused (`_refuse_train_mode_rates`).
    """
    _refuse_train_mode_rates(model)
    full_f32()

    def step(state: TrainState, batch, generator=None, *, t=None,
             noise=None):
        zero_pose = batch["zero_pose_obj"]
        memory, gt = model.encode(batch["skeleton"], batch["obj_points"],
                                  batch["poses"], zero_pose)
        if t is None:
            t, _ = sample_timesteps(generator, gt.shape[0],
                                    diffusion.num_timesteps, gt.device)
        if noise is None:
            noise = randn_rows(gt.shape, generator, gt.device, gt.dtype)

        def model_fn(x, ts):
            return model.denoise(x, ts, zero_pose, memory)

        pred, target = diffusion.training_losses(model_fn, gt, t, noise=noise)
        loss, terms = skeleton_diffusion_losses(
            pred, target, past_len=model.past_len,
            num_joints=model.num_joints, num_points=model.num_points,
            weights=weights)
        _optimise(state, loss)
        return state, _metrics(terms, loss)

    return step


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
    parameter's ``.grad`` holds this step's gradient.  A model with
    ``dropout`` or ``cond_mask_prob`` above 0 is refused
    (`_refuse_train_mode_rates`).
    """
    _refuse_train_mode_rates(model)
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
            noise = randn_rows(gt.shape, generator, gt.device, gt.dtype)

        def model_fn(x, ts):
            return model.denoise(x, ts, memory)

        pred, target = diffusion.training_losses(model_fn, gt, t, noise=noise)
        per_sample, terms = smpl_diffusion_losses(
            pred, target, past_len=model.past_len, smpl_dim=model.smpl_dim,
            weights=weights)
        loss = (per_sample * sampler_w).mean()
        _optimise(state, loss)

        per_sample = per_sample.detach()
        metrics = _metrics({k: v.mean() for k, v in terms.items()}, loss)
        for q, v in quartile_metrics(t, per_sample,
                                     diffusion.num_timesteps).items():
            metrics[f"loss_{q}"] = v
        if resampler is not None:
            state.sampler_state = resampler.update(
                state.sampler_state, t, per_sample)
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# correction networks (BatchNorm running statistics are state)
# ---------------------------------------------------------------------------


def adam(lr: float = 3e-4) -> Callable[[Any], torch.optim.Optimizer]:
    """`optax.adam(lr)` as ``tx(parameters) -> optimiser``: betas 0.9 and
    0.999, eps 1e-8, no weight decay, the ``foreach`` implementation."""
    def tx(parameters) -> torch.optim.Optimizer:
        return torch.optim.Adam(parameters, lr=lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=0.0, foreach=True)
    return tx


@dataclass
class CorrectionTrainState:
    """Step counter, the projector's parameters by name (the flax
    ``params`` tree), its BatchNorm running statistics by name (the flax
    ``batch_stats``, buffers the forward moves in place) and Adam over the
    parameters."""

    step: int
    params: Params
    batch_stats: Params
    optimizer: torch.optim.Optimizer

    @classmethod
    def create(cls, projector: torch.nn.Module, tx
               ) -> "CorrectionTrainState":
        params = dict(projector.named_parameters())
        stats = {k: v for k, v in projector.state_dict(keep_vars=True).items()
                 if k.rsplit(".", 1)[-1] in _BN_STATS}
        return cls(step=0, params=params, batch_stats=stats,
                   optimizer=tx(list(params.values())))

    def apply_gradients(self) -> "CorrectionTrainState":
        self.optimizer.step()
        self.step += 1
        return self


def correction_smpl_inputs(batch: Dict[str, torch.Tensor], past_len: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(obj_gt [B,T,9] rot6d | trans, contact [B,P] the per-marker contact
    counts over the future frames) of a correction batch."""
    contact = batch["markers"][:, past_len:, :, 6].sum(dim=1)
    rot6d = matrix_to_rotation_6d(axis_angle_to_matrix(batch["obj_angles"]))
    return torch.cat([rot6d, batch["obj_trans"]], dim=-1), contact


def make_correction_smpl_train_step(
    projector: ObjProjectorSmpl, *,
    weights: Optional[CorrectionLossWeights] = None,
    initialize: bool = False,
) -> Callable:
    """`train_correction_smpl.py:187-189,263`: contact and penetration plus
    the 8 pose terms.  ``initialize`` is the mean-marker mode of the first
    10 epochs, a plain bool: build one step per phase.

    Returns ``step(state, batch, generator=None, epoch=0, *,
    marker_idx=None) -> (state, metrics)``.  ``batch`` holds tensors
    ``obj_angles`` / ``obj_trans`` [B,T,3] (axis-angle), ``markers``
    [B,T,67,7] (xyz | normal | contact), ``human_verts`` [B,T,V,7] and
    ``obj_points`` [B,P,>=3].  The marker of each sample is drawn from
    ``generator`` (and so is dropout) unless ``marker_idx`` [B] is given,
    which is how a test hands this step the JAX step's draw.  ``metrics``:
    ``loss`` and the 10 weighted terms, 0-d tensors on the device.
    """
    full_f32()
    weights = weights or CorrectionLossWeights()

    def step(state: CorrectionTrainState, batch, generator=None,
             epoch: float = 0, *, marker_idx=None):
        obj_gt, contact = correction_smpl_inputs(batch, projector.past_len)
        obj_pred = projector.sample(
            obj_gt, batch["markers"][..., :3], contact,
            initialize=initialize, train=True, generator=generator,
            marker_idx=marker_idx)
        loss, terms = correction_smpl_losses(
            obj_pred, obj_gt, past_len=projector.past_len,
            obj_points=batch["obj_points"], human_verts=batch["human_verts"],
            epoch=epoch, weights=weights)
        _optimise(state, loss)
        return state, _metrics(terms, loss)

    return step


def make_correction_skeleton_train_step(
    projector: ObjProjectorSkeleton, *,
    weights: Optional[CorrectionLossWeights] = None,
) -> Callable:
    """`train_correction_skeleton.py:128-160`: the quaternion-space 8-term
    loss.  Returns ``step(state, batch, generator=None, epoch=0) ->
    (state, metrics)``; ``batch`` holds ``skeleton`` [B,T,21,3] and
    ``poses`` [B,T,7] (trans | quat xyzw).  ``generator`` feeds dropout
    only; ``epoch`` is accepted for the SMPL step's signature."""
    full_f32()
    weights = weights or CorrectionLossWeights()

    def step(state: CorrectionTrainState, batch, generator=None,
             epoch: float = 0):
        poses = batch["poses"]
        quat_gt, trans_gt = poses[..., 3:7], poses[..., :3]
        quat_p, trans_p = projector.sample(quat_gt, trans_gt,
                                           batch["skeleton"], train=True,
                                           generator=generator)
        # [quat | trans], so that [..., :-3] / [..., -3:] split as the ref
        obj_pred = torch.cat([quat_p, trans_p], dim=-1)
        obj_gt = torch.cat([quat_gt, trans_gt], dim=-1)
        loss, terms = correction_skeleton_losses(
            obj_pred, obj_gt, past_len=projector.past_len, weights=weights)
        _optimise(state, loss)
        return state, _metrics(terms, loss)

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


def data_parallel_step(step_fn: Callable, mesh: Optional[DataMesh], *,
                       extra_args: int = 1, batch_axis: int = 0) -> Callable:
    """A train step ``(state, batch, *extras, **kwargs) -> (state,
    metrics)`` over the data mesh (`interdiff_tpu/train/trainer.py:422-
    448`): each rank calls it with its own rows of the global batch (and of
    any explicit draw, ``t``, ``noise`` or ``marker_idx``), the state
    replicated, and gets back the same state as every other rank and the
    global batch's metrics (see the module's docstring).  ``extra_args``
    counts the trailing positional arguments every rank passes alike (the
    generator, the epoch).  ``batch_axis``: the rows' axis, 1 for a
    `chain_steps` step's stacked batch [K, B, ...].

    ``.place_batch(global batch, keys=None)`` cuts a host batch to this
    rank's rows on its device (`parallel/mesh.py::shard_batch`).  At one
    rank, with a process group or without, it computes what ``step_fn``
    does, bit for bit."""

    def step(state, batch, *extras, **kwargs):
        if len(extras) > extra_args:
            raise TypeError(f"{len(extras)} trailing arguments, the step "
                            f"takes {extra_args}")
        with use_mesh(mesh):
            return step_fn(state, batch, *extras, **kwargs)

    step.place_batch = lambda batch, keys=None: place_batch(
        shard_batch(batch, mesh, axis=batch_axis),
        mesh.device if mesh is not None else "cpu", keys)
    return step
