"""Train the SMPL-track MDM (`interdiff_tpu/cli/train_diffusion_smpl.py`, the
reference's `interdiff/train_diffusion_smpl.py`).

Usage:
  python -m interdiff_torch.cli.train_diffusion_smpl --motion_path DIR \\
      --model_path <SMPLH pkl dir> [--epochs 1000] [--batch_size 32] \\
      [--lr 3e-4] [--schedule_sampler uniform] [--ema_decay 0.9999] \\
      [--bn_train_mode 1] [--steps_per_dispatch K] [--val_every 50] \\
      [--val_respacing 25] [--val_diverse N] [--resume_checkpoint model.pt] \\
      [--use_pointnet2 0] [--profiler simple|trace] [--debug_nan] \\
      [--results_dir DIR] [--device cpu]
  python -m interdiff_torch.cli.train_diffusion_smpl --synthetic N_steps ...

It runs on the CUDA device unless ``--device`` names another; without a CUDA
device and without ``--device`` it stops.  The dataset route trains on the
train split of ``--motion_path`` (the clips shuffled every epoch, the
window jitter drawn anew) and validates every ``--val_every`` epochs on the
first batch of the test split, or on the epoch's last train batch when the
corpus has no Date03* sequence (``--config`` may name both paths,
``--synthetic_body`` stands in for the pkls).  ``--synthetic N`` trains on
N random batches, one epoch and one validation.  The batches are built on
the main thread between steps: JAX's two prefetch threads
(`utils/prefetch.py::threaded_batches`) slow the port's eager step, whose
dispatch holds the interpreter lock the clip building needs (PERF.md §6).
``--use_pointnet2 0`` encodes the object cloud by the linear
encoder over [xyz | normal] instead of PointNet++.  ``--profiler simple``
prints the seconds of the sections ``batch_place`` and ``train_step`` at
the end, ``--profiler trace`` writes a `torch.profiler` trace to
``<results_dir>/trace``, ``--debug_nan`` turns on torch's anomaly
detection with NaN checks.  ``--render_interval N`` renders a four-view
gif of validation sample 0 every N validations into
``<results_dir>/render`` (the reference's validation gifs; every
validation under ``--synthetic``, on the 128-vertex stand-in body there).
``--resume_checkpoint`` takes a state-dict file of the port
(`utils/convert.py::save_state_dict`, as ``ckpt/step_<n>.pt`` here) or the
JAX trainer's orbax ``ckpt`` directory, weights only, at its latest step
(`utils/orbax_read.py`).

Data parallelism, as the JAX trainer runs over every local device: on a
machine with several cards it spawns one rank a card (under ``torchrun``
each process is a rank; ``torchrun --nproc_per_node 2 -m
interdiff_torch.cli.train_diffusion_smpl --device cpu ...`` runs two gloo
ranks on the CPU), the mesh takes the largest count of ranks that divides
``--batch_size`` (`parallel/mesh.py::make_mesh`), every rank steps its rows
of each batch through `train/trainer.py::data_parallel_step`, and rank 0
alone validates, renders, profiles and writes ``ckpt/``, ``ckpt_ema/``,
``metrics.jsonl`` and ``src_snapshot/``.  With one card it is one rank.

``main`` builds the objects from the flags; ``train`` is the loop itself, on
any model and any source of batches.  It writes ``<results_dir>/ckpt/``
(the weights), ``ckpt_ema/`` (the EMA shadow, with ``--ema_decay``) and
``metrics.jsonl``.  Both checkpoints hold a whole state dict that every
entry point of the port loads; under ``--bn_train_mode`` the shadow is saved
with the current BatchNorm statistics, which the EMA does not cover.
"""

from __future__ import annotations

import copy
import os
from argparse import ArgumentParser
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.cli.common import (
    TrainProfiler,
    add_data_args,
    add_profiler_args,
    batch_iterator,
    check_data_args,
    check_render_interval,
    launch_trainer,
    load_smpl_models,
    load_weights,
    render_smpl_sample,
    seed_everything,
    snapshot_sources,
    stack_batches,
    synthetic_smpl_batches,
    synthetic_smpl_body,
)
from interdiff_torch.config import DiffusionConfig, SmplTrackConfig
from interdiff_torch.data.behave import (
    BehaveDataset,
    collate,
    load_behave_sequences,
)
from interdiff_torch.diffusion.gaussian import GaussianDiffusion
from interdiff_torch.diffusion.resample import LossSecondMomentResampler
from interdiff_torch.eval.smpl_short import (
    SmplEvalConfig,
    make_sampler,
    postprocess_sample,
    state_to_axis_angle,
)
from interdiff_torch.models.mdm_smpl import MDMSmpl, smpl_gt_from_raw
from interdiff_torch.parallel.mesh import (
    DataMesh,
    is_rank0,
    make_mesh,
    process_device,
    replicated,
    sync_generator,
    wait_for_rank0,
)
from interdiff_torch.parallel.sample_parallel import tile_for_diverse_samples
from interdiff_torch.smpl.model import SmplModel
from interdiff_torch.train.losses import (
    smpl_diverse_test_losses,
    smpl_val_losses,
)
from interdiff_torch.train.trainer import (
    TrainState,
    adamw,
    chain_steps,
    data_parallel_step,
    make_smpl_train_step,
    merge_bn_state,
    split_bn_state,
)
from interdiff_torch.utils.train_io import CheckpointManager, MetricsLogger

KEEP = ("body_pose", "body_trans", "obj_angles", "obj_trans", "obj_points")
SNAPSHOT = ("interdiff_torch.models.mdm_smpl", "interdiff_torch.train.trainer",
            "interdiff_torch.train.losses",
            "interdiff_torch.diffusion.gaussian")
Batch = Dict[str, np.ndarray]


def make_validation(model: MDMSmpl, val_diffusion: GaussianDiffusion, *,
                    past_len: int, future_len: int, val_diverse: int = 1
                    ) -> Callable:
    """``run_validation(batch, generator) -> (loss, terms)``: the
    inpainting sampler on a raw batch, then the rotation-matrix-space
    validation loss (`calc_val_loss`) or, with ``val_diverse`` > 1, the
    diverse-sample test loss with its ``*_min`` terms (`calc_loss`)."""
    cfg = SmplEvalConfig(past_len=past_len, future_len=future_len)
    sampler = make_sampler(cfg, model, val_diffusion)
    device = next(model.parameters()).device

    @torch.no_grad()
    def run_validation(batch: Batch, generator=None
                       ) -> Tuple[float, Dict[str, float]]:
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
             if k in KEEP + ("body_betas",)}
        gt = smpl_gt_from_raw(b["body_pose"][..., :66], b["body_trans"],
                              b["obj_angles"], b["obj_trans"])
        args = (gt, b["obj_points"][..., :6], b["body_pose"][..., 66:],
                b["body_betas"] if "body_betas" in b
                else gt.new_zeros(gt.shape[:2] + (10,)))
        body_g, obj_g = state_to_axis_angle(cfg, gt)
        if val_diverse > 1:
            x = sampler(*tile_for_diverse_samples(args, val_diverse),
                        generator=generator)
            body_p, obj_p = state_to_axis_angle(cfg, x)
            B = gt.shape[0]
            loss, terms, _ = smpl_diverse_test_losses(
                body_p.reshape((val_diverse, B) + body_p.shape[1:]), body_g,
                obj_p.reshape((val_diverse, B) + obj_p.shape[1:]), obj_g,
                past_len=past_len)
        else:
            x = sampler(*args, generator=generator)
            body_p, obj_p = state_to_axis_angle(cfg, x)
            loss, terms = smpl_val_losses(body_p, body_g, obj_p, obj_g,
                                          past_len=past_len)
        names = list(terms)  # one read of the device
        values = torch.stack([loss] + [terms[k] for k in names]).tolist()
        return values[0], dict(zip(names, values[1:]))

    return run_validation


def make_validation_render(model: MDMSmpl, val_diffusion: GaussianDiffusion,
                           smpl: SmplModel, *, past_len: int,
                           future_len: int) -> Callable:
    """``render(batch, generator, path)``: the gif of the validation
    sampler's sample of the batch's first clip, FK on ``smpl``, the seam
    smoothed, the object as spheres of its template cloud
    (`interdiff_tpu/cli/train_diffusion_smpl.py:294-330`)."""
    cfg = SmplEvalConfig(past_len=past_len, future_len=future_len)
    sampler = make_sampler(cfg, model, val_diffusion)
    device = next(model.parameters()).device

    @torch.no_grad()
    def render(batch: Batch, generator, path: str) -> np.ndarray:
        b = {k: torch.as_tensor(v[:1], device=device)
             for k, v in batch.items() if k in KEEP + ("body_betas",)}
        gt = smpl_gt_from_raw(b["body_pose"][..., :66], b["body_trans"],
                              b["obj_angles"], b["obj_trans"])
        hand = b["body_pose"][..., 66:]
        betas = b["body_betas"] if "body_betas" in b \
            else gt.new_zeros(gt.shape[:2] + (10,))
        x = sampler(gt, b["obj_points"][..., :6], hand, betas,
                    generator=generator)
        out = postprocess_sample(cfg, smpl, x, hand, betas)
        return render_smpl_sample(cfg, smpl, out,
                                  b["obj_points"][0, :, :3].cpu().numpy(),
                                  None, path)

    return render


def train(model: MDMSmpl, diffusion: GaussianDiffusion,
          epoch_batches: Callable[[], Iterable[Batch]], *, results_dir: str,
          epochs: int = 1, lr: float = 3e-4,
          schedule_sampler: str = "uniform", ema_decay: float = 0.0,
          steps_per_dispatch: int = 1, bn_train_mode: bool = False,
          val_every: int = 50, validate_every_epoch: bool = False,
          val_diverse: int = 1,
          val_diffusion: Optional[GaussianDiffusion] = None,
          val_batch: Optional[Batch] = None,
          generator: Optional[torch.Generator] = None,
          on_step: Optional[Callable] = None,
          profiler: Optional[TrainProfiler] = None,
          render_interval: int = 0,
          render_smpl: Optional[SmplModel] = None,
          mesh: Optional[DataMesh] = None
          ) -> Tuple[TrainState, Dict]:
    """The training loop (`interdiff_tpu/cli/train_diffusion_smpl.py:341-429`)
    on the model's device; returns (the final `TrainState`, a summary with
    ``steps`` and the validations' ``val_loss`` and ``val_terms``).

    ``epoch_batches()`` yields one epoch of raw batches (``body_pose``
    [B,T,156], ``body_trans``, ``obj_angles``, ``obj_trans`` [B,T,3],
    ``obj_points`` [B,P,6], optional ``body_betas``; numpy).  Every
    ``val_every`` epochs (every epoch with ``validate_every_epoch``) it
    samples ``val_batch`` (the epoch's last train batch when None) with
    ``val_diffusion`` and the EMA shadow where there is one, logs the
    validation loss and saves ``ckpt/`` and ``ckpt_ema/``.  The timesteps,
    the training noise and the validation's noise come from ``generator``.
    ``on_step(steps so far, state, metrics)`` is called after every
    dispatch with the metrics still on the device.  ``profiler`` times the
    sections ``batch_place`` and ``train_step``.  Every ``render_interval``
    validations (none at 0) `make_validation_render` writes
    ``<results_dir>/render/epoch<e>.gif`` on the body ``render_smpl``.

    With a data ``mesh`` rank 0's weights go to every rank, each rank steps
    its rows of every batch (`data_parallel_step`), and rank 0 alone
    prints, validates (as a run of one rank does, on the whole validation
    batch; the generator's state is then broadcast, so the ranks keep
    drawing alike), renders and writes; the other ranks' summaries hold no
    validation.
    """
    if render_interval and render_smpl is None:
        raise ValueError("render_interval needs the body `render_smpl`")
    device = next(model.parameters()).device
    rank0 = is_rank0(mesh)
    replicated(model, mesh)
    spd = max(1, steps_per_dispatch)
    sampler_state = None
    if schedule_sampler == "loss-second-moment":
        # one instance feeds both init_state() and the step factory, so the
        # history width in the state matches the update
        schedule_sampler = LossSecondMomentResampler(diffusion.num_timesteps)
        sampler_state = schedule_sampler.init_state()
    if bn_train_mode:
        params, model_state = split_bn_state(model)
    else:
        params, model_state = dict(model.named_parameters()), None
    state = TrainState.create(params, adamw(lr), sampler_state=sampler_state,
                              ema_rate=ema_decay, model_state=model_state)
    step = make_smpl_train_step(model, diffusion,
                                schedule_sampler=schedule_sampler,
                                bn_train_mode=bn_train_mode)
    if spd > 1:
        step = chain_steps(step)
    place = None
    if mesh is not None:
        step = data_parallel_step(step, mesh, batch_axis=1 if spd > 1 else 0)
        place = lambda stacked: step.place_batch(stacked, KEEP)  # noqa: E731

    ckpt = ckpt_ema = logger = run_validation = render = None
    if rank0:
        ckpt = CheckpointManager(os.path.join(results_dir, "ckpt"))
        ckpt_ema = (CheckpointManager(os.path.join(results_dir, "ckpt_ema"))
                    if ema_decay > 0 else None)
        logger = MetricsLogger(os.path.join(results_dir, "metrics.jsonl"))
        # with EMA on, validation (and so the choice of the best
        # checkpoint) scores the shadow weights, loaded into a second module
        val_model = copy.deepcopy(model) if ema_decay > 0 else model
        run_validation = make_validation(
            val_model, val_diffusion or diffusion, past_len=model.past_len,
            future_len=model.future_len, val_diverse=val_diverse)
        render = make_validation_render(
            val_model, val_diffusion or diffusion, render_smpl,
            past_len=model.past_len, future_len=model.future_len) \
            if render_interval else None

    prof = profiler if profiler is not None else TrainProfiler(results_dir)
    i, n_vals, summary = 0, 0, {"val_loss": [], "val_terms": []}
    try:
        for epoch in range(epochs):
            batch_np = None
            for batch_np, batch in stack_batches(
                    epoch_batches(), spd, device, KEEP, prof.section, place):
                with prof.section("train_step"):
                    state, metrics = step(state, batch, generator)
                if rank0 and (i // spd) % max(1, 10 // spd) == 0:
                    # chained dispatches return stacked [K] metrics: log the
                    # mean
                    loss = float(metrics["loss"].mean())
                    logger.log(i, {"loss": loss}, epoch=epoch)
                    print(f"step {i} loss {loss:.4f}", flush=True)
                i += spd
                if on_step is not None:
                    on_step(i, state, metrics)
            if (epoch + 1) % val_every == 0 or validate_every_epoch:
                if rank0:
                    vb = batch_np if val_batch is None else val_batch
                    if state.ema_params is not None:
                        val_model.load_state_dict(merge_bn_state(
                            state.ema_params, state.model_state), strict=True)
                    val_loss, val_terms = run_validation(vb, generator)
                    logger.log(i, {"val_loss": val_loss, **val_terms},
                               epoch=epoch)
                    print(f"epoch {epoch} val_loss {val_loss:.4f}",
                          flush=True)
                    summary["val_loss"].append(val_loss)
                    summary["val_terms"].append(val_terms)
                    ckpt.save(i, merge_bn_state(state.params,
                                                state.model_state),
                              val_loss=val_loss)
                    if ckpt_ema is not None:
                        ckpt_ema.save(i, merge_bn_state(state.ema_params,
                                                        state.model_state),
                                      val_loss=val_loss)
                    n_vals += 1
                    if render is not None and n_vals % render_interval == 0:
                        render(vb, generator, os.path.join(
                            results_dir, "render", f"epoch{epoch}.gif"))
                # the other ranks wait for rank 0's validation, outside the
                # collectives; rank 0 drew the validation noise, so its
                # generator state goes to every rank
                wait_for_rank0(mesh)
                sync_generator(generator, mesh)
    finally:
        prof.finish()
    summary["steps"] = i
    if rank0:
        ckpt.wait()
        if ckpt_ema is not None:
            ckpt_ema.wait()
        logger.close()
        print("done:", i, "steps", flush=True)
    return state, summary


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--results_dir", default="./results/smpl_diffusion")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--past_len", type=int, default=10)
    parser.add_argument("--future_len", type=int, default=25)
    parser.add_argument("--bn_train_mode", type=int, default=0,
                        help="1 = run the PointNet++ encoder BatchNorms in "
                        "train mode (batch statistics, running statistics "
                        "moved by momentum and out of the optimiser: the "
                        "reference's Lightning semantics); 0 (default) "
                        "keeps eval-mode BatchNorm with the statistics "
                        "among the optimised parameters")
    parser.add_argument("--embedding_dim", type=int, default=256)
    parser.add_argument("--ff_size", type=int, default=1024)
    parser.add_argument("--num_layers", type=int, default=8)
    parser.add_argument("--use_pointnet2", type=int, default=1,
                        help="1 = PointNet++ object encoder; 0 = the linear "
                             "encoder over [xyz | normal] averaged over the "
                             "points")
    parser.add_argument("--schedule_sampler", default="uniform",
                        choices=["uniform", "loss-second-moment"],
                        help="timestep sampler; the reference hardcodes "
                             "uniform")
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help=">0 keeps an EMA shadow of the parameters (rate "
                             "= this value, e.g. 0.9999); validation scores "
                             "the shadow and ckpt_ema/ stores it")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="optimiser steps per dispatch "
                        "(train/trainer.py::chain_steps): K batches are "
                        "stacked and stepped in turn; metrics land every K "
                        "steps")
    parser.add_argument("--seed", type=int, default=233)
    parser.add_argument("--resume_checkpoint", default=None,
                        help="weights to start from: a state-dict file of "
                             "the port, or an orbax directory of the JAX "
                             "package (its trainer's CheckpointManager "
                             "directory at the latest step, or a flat save)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic batches (no dataset)")
    parser.add_argument("--synthetic_points", type=int, default=512,
                        help="object points per synthetic batch")
    parser.add_argument("--val_every", type=int, default=50)
    parser.add_argument("--val_diverse", type=int, default=1,
                        help=">1 scores validation with the reference's "
                             "test-mode calc_loss: N diverse samples, mean "
                             "terms and per-clip min-over-samples *_min "
                             "terms")
    parser.add_argument("--val_respacing", default="",
                        help="timestep respacing of the validation sampler "
                             "('' = the full schedule; e.g. '25')")
    parser.add_argument("--render_interval", type=int, default=0,
                        help="render a 4-view mesh gif of validation sample "
                             "0 every N validations into "
                             "<results_dir>/render (every validation under "
                             "--synthetic, on the stand-in body)")
    add_profiler_args(parser)
    add_data_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def dataset_batches(args, smpl_models, rng: np.random.Generator
                    ) -> Tuple[Callable[[], Iterable[Batch]],
                               Optional[Batch]]:
    """(``epoch_batches`` over the train split of ``args.motion_path``,
    shuffled by ``rng``; the validation batch, the first of the test split
    in order, or None when the corpus has none) with light fields: the
    trainer reads the pose streams and the template cloud only."""
    ds = BehaveDataset(load_behave_sequences(
        args.motion_path, smpl_models=smpl_models, mode="train"),
        past_len=args.past_len, future_len=args.future_len, rng=rng,
        fields="light")
    test_ds = BehaveDataset(load_behave_sequences(
        args.motion_path, smpl_models=smpl_models, mode="test"),
        past_len=args.past_len, future_len=args.future_len, rng=rng,
        fields="light")
    val_batch = next(iter(batch_iterator(
        test_ds, collate, batch_size=args.batch_size, rng=rng,
        shuffle=False)), None)
    if val_batch is None:
        print("no full test batch: validation falls back to the last train "
              "batch", flush=True)

    def epoch_batches():
        return batch_iterator(ds, collate, batch_size=args.batch_size,
                              rng=rng)

    return epoch_batches, val_batch


def main(argv=None) -> Tuple[Optional[TrainState], Dict]:
    """Parse the flags and train on one rank a visible card
    (`cli/common.py::launch_trainer`); returns (the state, the summary), or
    (None, rank 0's summary) from spawned ranks."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_data_args(parser, args)
    check_render_interval(parser, args.render_interval)
    device = resolve_device(None if args.device == "cuda" else args.device)
    return launch_trainer(run, args, device)


def run(args, device) -> Tuple[Optional[TrainState], Dict]:
    """One rank of :func:`main` (the whole run at one rank)."""
    device = process_device(device)
    rng = seed_everything(args.seed)
    mesh = make_mesh(batch_size=args.batch_size, device=device)
    if mesh is None:  # a rank the batch's divisor rule leaves out
        return None, {}
    rank0 = is_rank0(mesh)
    track = SmplTrackConfig(past_len=args.past_len,
                            future_len=args.future_len,
                            embedding_dim=args.embedding_dim,
                            ff_size=args.ff_size, num_layers=args.num_layers,
                            use_pointnet2=bool(args.use_pointnet2))
    model = track.build_model(device)
    if rank0:  # the other ranks receive rank 0's weights in `train`
        load_weights(model, args.resume_checkpoint)
        if args.resume_checkpoint:
            print(f"resumed parameters from {args.resume_checkpoint}")
        snapshot_sources(args.results_dir, SNAPSHOT)
    val_diffusion = None
    if args.val_respacing:
        val_diffusion = DiffusionConfig(
            timestep_respacing=args.val_respacing).build(device)

    val_batch = None
    if args.synthetic:
        def epoch_batches():
            return synthetic_smpl_batches(
                rng, batch_size=args.batch_size,
                seq_len=args.past_len + args.future_len,
                num_points=args.synthetic_points, steps=args.synthetic)
        render_smpl = synthetic_smpl_body(
            np.random.default_rng(0),
            device=device) if args.render_interval else None
    else:
        smpl_models = load_smpl_models(args, device)
        epoch_batches, val_batch = dataset_batches(args, smpl_models, rng)
        render_smpl = smpl_models["male"]

    # a synthetic run is one epoch with one validation, whatever --epochs
    return train(
        model, track.diffusion.build(device), epoch_batches,
        results_dir=args.results_dir,
        epochs=1 if args.synthetic else args.epochs, lr=args.lr,
        schedule_sampler=args.schedule_sampler, ema_decay=args.ema_decay,
        steps_per_dispatch=args.steps_per_dispatch,
        bn_train_mode=bool(args.bn_train_mode), val_every=args.val_every,
        validate_every_epoch=bool(args.synthetic),
        val_diverse=args.val_diverse, val_diffusion=val_diffusion,
        val_batch=val_batch,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        profiler=TrainProfiler.from_args(args, args.results_dir, device)
        if rank0 else None,
        # every validation renders under --synthetic, as in JAX
        render_interval=(1 if args.synthetic else args.render_interval)
        if args.render_interval else 0,
        render_smpl=render_smpl, mesh=mesh)


if __name__ == "__main__":
    main()
