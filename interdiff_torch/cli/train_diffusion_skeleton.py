"""Train the skeleton-track MDM (`interdiff_tpu/cli/train_diffusion_skeleton.py`,
the reference's `interdiff/train_diffusion_skeleton.py`).

Usage:
  python -m interdiff_torch.cli.train_diffusion_skeleton --synthetic N_steps \\
      [--batch_size 32] [--lr 3e-4] [--ema_decay 0.9999] \\
      [--steps_per_dispatch K] [--val_respacing 25] \\
      [--resume_checkpoint model.pt] [--profiler simple|trace] \\
      [--debug_nan] [--results_dir DIR] [--device cpu]
  python -m interdiff_torch.cli.train_diffusion_skeleton --motion_path DIR ...

It runs on the CUDA device unless ``--device`` names another; without a CUDA
device and without ``--device`` it stops.  ``--motion_path`` reads the
HO-GCN sequence pickles (`data/skeleton.py`), trains on the train split and
validates on a batch of the validation split every ``--val_every`` epochs;
``--synthetic N`` trains on N random batches, one epoch with one
validation.  Validation runs the full inpainting sampler
(``--val_respacing``) and scores `skeleton_metrics` (the reference's
`validation_step`, `train_diffusion_skeleton.py:272-295`), on the EMA
shadow when there is one.  ``--resume_checkpoint`` takes a state-dict file
of the port (`utils/convert.py::save_state_dict`) or the JAX trainer's
orbax ``ckpt`` directory, weights only, at its latest step
(`utils/orbax_read.py`).  ``--config`` may name the motion path in a YAML
path config (PyYAML is imported only then).  The
batches are built on the main thread between steps, as in the SMPL
trainer; ``--profiler`` and ``--debug_nan`` as there.  ``--render_interval
N`` draws validation sample 0, the prediction over the ground truth, as a
gif in ``<results_dir>/render`` every N validations (every validation under
``--synthetic``; matplotlib on the host, without which the flag stops
before anything is built).

Data parallelism as in `cli/train_diffusion_smpl.py`: one rank a visible
card (or a torchrun process), the mesh over the largest count of ranks that
divides ``--batch_size``, `train/trainer.py::data_parallel_step`, and rank
0 alone validating and writing.

``main`` builds the objects from the flags; ``train`` is the loop itself.
It writes ``<results_dir>/ckpt/`` (the weights, the best three by the
validation's ``mpjpe_h``), ``ckpt_ema/`` (the shadow, with
``--ema_decay``) and ``metrics.jsonl``.
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
    add_profiler_args,
    batch_iterator,
    check_render_interval,
    fit_batch_size,
    launch_trainer,
    load_weights,
    seed_everything,
    snapshot_sources,
    stack_batches,
    synthetic_skeleton_batches,
)
from interdiff_torch.cli.eval_skeleton import render_clip
from interdiff_torch.config import DiffusionConfig, SkeletonTrackConfig
from interdiff_torch.data.paths import load_paths
from interdiff_torch.parallel.mesh import (
    DataMesh,
    is_rank0,
    make_mesh,
    process_device,
    replicated,
    sync_generator,
    wait_for_rank0,
)
from interdiff_torch.diffusion.gaussian import GaussianDiffusion
from interdiff_torch.eval.metrics import skeleton_metrics
from interdiff_torch.eval.skeleton import (
    SkeletonEvalConfig,
    make_skeleton_sampler,
    split_skeleton_state,
)
from interdiff_torch.models.mdm_skeleton import MDMSkeleton
from interdiff_torch.viz.skeleton_viz import require_matplotlib
from interdiff_torch.train.trainer import (
    TrainState,
    adamw,
    chain_steps,
    data_parallel_step,
    make_skeleton_train_step,
)
from interdiff_torch.utils.train_io import CheckpointManager, MetricsLogger

SNAPSHOT = ("interdiff_torch.models.mdm_skeleton",
            "interdiff_torch.train.trainer", "interdiff_torch.train.losses",
            "interdiff_torch.diffusion.gaussian")
KEYS = ("skeleton", "obj_points", "poses", "zero_pose_obj")
Batch = Dict[str, np.ndarray]


def make_validation(model: MDMSkeleton, val_diffusion: GaussianDiffusion
                    ) -> Callable:
    """``run_validation(batch, generator) -> (metrics, prediction)``: the
    inpainting sampler without correction on a raw batch, then
    `skeleton_metrics` on the frames after the model's ``past_len``, as
    floats; the prediction's ``body``, ``obj`` and ``pose`` on the
    device."""
    past_len = model.past_len
    cfg = SkeletonEvalConfig(past_len=past_len)
    sampler = make_skeleton_sampler(cfg, model, val_diffusion)
    device = next(model.parameters()).device

    @torch.no_grad()
    def run_validation(batch: Batch, generator=None
                       ) -> Tuple[Dict[str, float], Dict[str, torch.Tensor]]:
        b = {k: torch.as_tensor(batch[k], device=device) for k in KEYS}
        x = sampler(*(b[k] for k in KEYS), generator=generator)
        pred = split_skeleton_state(x, cfg)
        m = skeleton_metrics(pred["body"], b["skeleton"], pred["obj"],
                             b["obj_points"], pred["pose"], b["poses"],
                             start=past_len)
        return dict(zip(m, torch.stack(list(m.values())).tolist())), pred

    return run_validation


def train(model: MDMSkeleton, diffusion: GaussianDiffusion,
          epoch_batches: Callable[[], Iterable[Batch]], *, results_dir: str,
          epochs: int = 1, lr: float = 3e-4,
          ema_decay: float = 0.0, steps_per_dispatch: int = 1,
          val_every: int = 10, validate_every_epoch: bool = False,
          val_diffusion: Optional[GaussianDiffusion] = None,
          val_batch: Optional[Batch] = None,
          generator: Optional[torch.Generator] = None,
          on_step: Optional[Callable] = None,
          profiler: Optional[TrainProfiler] = None,
          render_interval: int = 0,
          mesh: Optional[DataMesh] = None
          ) -> Tuple[TrainState, Dict]:
    """The training loop
    (`interdiff_tpu/cli/train_diffusion_skeleton.py:199-268`) on the model's
    device; returns (the final `TrainState`, a summary with ``steps`` and
    the validations' metric dicts under ``val``).

    ``epoch_batches()`` yields one epoch of raw batches (``skeleton``
    [B,T,21,3], ``obj_points`` [B,T,12,3], ``poses`` [B,T,7],
    ``zero_pose_obj`` [B,12,3]; numpy).  Every ``val_every`` epochs (every
    epoch with ``validate_every_epoch``) it samples ``val_batch`` (the
    epoch's last train batch when None) with ``val_diffusion`` and the EMA
    shadow where there is one, logs the metrics and saves ``ckpt/`` and
    ``ckpt_ema/``, ranked by ``mpjpe_h``.  The timesteps, the training noise
    and the validation's noise come from ``generator``.  ``on_step(steps so
    far, state, metrics)`` is called after every dispatch with the metrics
    still on the device.  ``profiler`` times the sections ``batch_place``
    and ``train_step``.  Every ``render_interval`` validations (none at 0)
    `cli/eval_skeleton.py::render_clip` draws the first clip of the
    validation batch to ``<results_dir>/render/epoch<e>.gif``.  With a
    data ``mesh``, as `cli/train_diffusion_smpl.py::train`.
    """
    device = next(model.parameters()).device
    rank0 = is_rank0(mesh)
    replicated(model, mesh)
    spd = max(1, steps_per_dispatch)
    state = TrainState.create(dict(model.named_parameters()), adamw(lr),
                              ema_rate=ema_decay)
    step = make_skeleton_train_step(model, diffusion)
    if spd > 1:
        step = chain_steps(step)
    place = None
    if mesh is not None:
        step = data_parallel_step(step, mesh, batch_axis=1 if spd > 1 else 0)
        place = lambda stacked: step.place_batch(stacked, KEYS)  # noqa: E731

    ckpt = ckpt_ema = logger = run_validation = None
    if rank0:
        ckpt = CheckpointManager(os.path.join(results_dir, "ckpt"))
        ckpt_ema = (CheckpointManager(os.path.join(results_dir, "ckpt_ema"))
                    if ema_decay > 0 else None)
        logger = MetricsLogger(os.path.join(results_dir, "metrics.jsonl"))
        # with EMA on, validation scores the shadow, loaded into a second
        # module
        val_model = copy.deepcopy(model) if ema_decay > 0 else model
        run_validation = make_validation(val_model,
                                         val_diffusion or diffusion)

    prof = profiler if profiler is not None else TrainProfiler(results_dir)
    i, n_vals, summary = 0, 0, {"val": []}
    try:
        for epoch in range(epochs):
            batch_np = None
            for batch_np, batch in stack_batches(
                    epoch_batches(), spd, device, KEYS, prof.section, place):
                with prof.section("train_step"):
                    state, metrics = step(state, batch, generator)
                if rank0 and (i // spd) % max(1, 10 // spd) == 0:
                    loss = float(metrics["loss"].mean())
                    logger.log(i, {"loss": loss}, epoch=epoch)
                    print(f"step {i} loss {loss:.4f}", flush=True)
                i += spd
                if on_step is not None:
                    on_step(i, state, metrics)
            if ((epoch + 1) % val_every == 0 or validate_every_epoch) \
                    and rank0:
                if state.ema_params is not None:
                    val_model.load_state_dict(state.ema_params, strict=True)
                val_b = batch_np if val_batch is None else val_batch
                val_metrics, val_pred = run_validation(val_b, generator)
                logger.log(i, val_metrics, epoch=epoch, split="valid")
                print(f"epoch {epoch} val {val_metrics}", flush=True)
                summary["val"].append(val_metrics)
                ckpt.save(i, state.params, val_loss=val_metrics["mpjpe_h"])
                if ckpt_ema is not None:
                    ckpt_ema.save(i, state.ema_params,
                                  val_loss=val_metrics["mpjpe_h"])
                n_vals += 1
                if render_interval and n_vals % render_interval == 0:
                    render_clip({k: torch.as_tensor(val_b[k][:1])
                                 for k in ("skeleton", "obj_points")},
                                val_pred, model.past_len, os.path.join(
                                    results_dir, "render",
                                    f"epoch{epoch}.gif"))
            if (epoch + 1) % val_every == 0 or validate_every_epoch:
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
    parser.add_argument("--motion_path", default=None,
                        help="directory of HO-GCN sequence pickles")
    parser.add_argument("--config", default=None,
                        help="YAML path config (BEHAVE.yml/HOI.yml style; "
                             "needs PyYAML): its motion path")
    parser.add_argument("--results_dir",
                        default="./results/skeleton_diffusion")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--past_len", type=int, default=10)
    parser.add_argument("--future_len", type=int, default=10)
    parser.add_argument("--embedding_dim", type=int, default=256)
    parser.add_argument("--ff_size", type=int, default=256)
    parser.add_argument("--num_layers", type=int, default=8)
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help=">0 keeps an EMA shadow of the parameters (rate "
                             "= this value, e.g. 0.9999); validation scores "
                             "the shadow and ckpt_ema/ stores it")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="optimiser steps per dispatch "
                        "(train/trainer.py::chain_steps)")
    parser.add_argument("--seed", type=int, default=233)
    parser.add_argument("--resume_checkpoint", default=None,
                        help="weights to start from: a state-dict file of "
                             "the port, or an orbax directory of the JAX "
                             "package (its trainer's CheckpointManager "
                             "directory at the latest step, or a flat save)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic batches (no dataset)")
    parser.add_argument("--val_every", type=int, default=10)
    parser.add_argument("--val_respacing", default="",
                        help="timestep respacing of the validation sampler "
                             "('' = the full schedule; e.g. '25')")
    parser.add_argument("--render_interval", type=int, default=0,
                        help="render a pred-vs-gt skeleton gif of validation "
                             "sample 0 every N validations into "
                             "<results_dir>/render (every validation under "
                             "--synthetic)")
    add_profiler_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def main(argv=None) -> Tuple[Optional[TrainState], Dict]:
    """Parse the flags and train on one rank a visible card
    (`cli/common.py::launch_trainer`)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config:
        args.motion_path = args.motion_path or load_paths(
            args.config).motion_path
    if not args.synthetic and not args.motion_path:
        parser.error("--motion_path is required unless --synthetic is set")
    check_render_interval(parser, args.render_interval)
    if args.render_interval:
        try:
            require_matplotlib()
        except ImportError as e:
            parser.error(f"--render_interval: {e}")
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
    track = SkeletonTrackConfig(past_len=args.past_len,
                                future_len=args.future_len,
                                embedding_dim=args.embedding_dim,
                                ff_size=args.ff_size,
                                num_layers=args.num_layers)
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
    T = args.past_len + args.future_len

    val_batch, epochs = None, args.epochs
    if args.synthetic:
        epochs = 1  # one epoch with one validation, whatever --epochs

        def epoch_batches():
            return synthetic_skeleton_batches(
                rng, batch_size=args.batch_size, seq_len=T,
                steps=args.synthetic)
    else:
        from interdiff_torch.data.skeleton import (
            collate_skeleton,
            load_skeleton_datasets,
        )

        train_split, val_split, _, _ = load_skeleton_datasets(
            args.motion_path)

        def epoch_batches():
            return batch_iterator(train_split, collate_skeleton,
                                  batch_size=args.batch_size, rng=rng)

        if len(val_split):
            val_batch = next(iter(batch_iterator(
                val_split, collate_skeleton,
                batch_size=fit_batch_size(len(val_split), args.batch_size),
                rng=rng, shuffle=False)))

    return train(
        model, track.diffusion.build(device), epoch_batches,
        results_dir=args.results_dir, epochs=epochs, lr=args.lr,
        ema_decay=args.ema_decay,
        steps_per_dispatch=args.steps_per_dispatch, val_every=args.val_every,
        validate_every_epoch=bool(args.synthetic),
        val_diffusion=val_diffusion, val_batch=val_batch,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        profiler=TrainProfiler.from_args(args, args.results_dir, device)
        if rank0 else None,
        # every validation renders under --synthetic, as in JAX
        render_interval=(1 if args.synthetic else args.render_interval)
        if args.render_interval else 0, mesh=mesh)


if __name__ == "__main__":
    main()
