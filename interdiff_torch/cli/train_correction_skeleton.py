"""Train the skeleton-track correction network, `ObjProjectorSkeleton`
(`interdiff_tpu/cli/train_correction_skeleton.py`, the reference's
`interdiff/train_correction_skeleton.py`): Adam at lr 3e-4, the 8 pose terms
in quaternion space.

Usage:
  python -m interdiff_torch.cli.train_correction_skeleton \\
      --synthetic N_steps [--batch_size 32] [--results_dir DIR] \\
      [--device cpu]
  python -m interdiff_torch.cli.train_correction_skeleton --motion_path DIR ...

It runs on the CUDA device unless ``--device`` names another; without a CUDA
device and without ``--device`` it stops.  ``--motion_path`` reads the
HO-GCN sequence pickles (`data/skeleton.py`) and trains on the train split;
``--synthetic N`` trains on N random batches, one epoch.  ``--config`` may
name the motion path in a YAML path config (PyYAML is imported only then).
``--profiler simple|trace`` and ``--debug_nan`` as in the SMPL correction
trainer.

Data parallelism as in `cli/train_diffusion_smpl.py`: one rank a visible
card (or a torchrun process), the mesh over the largest count of ranks that
divides ``--batch_size``, `train/trainer.py::data_parallel_step`, rank 0
alone writing.

``main`` builds the objects from the flags; ``train`` is the loop itself.
It writes ``<results_dir>/ckpt/`` (the projector's state dict, BatchNorm
statistics included, every 40 epochs and after the last) and
``metrics.jsonl``.
"""

from __future__ import annotations

from argparse import ArgumentParser
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.cli.common import (
    batch_iterator,
    TrainProfiler,
    add_profiler_args,
    correction_train_loop,
    launch_trainer,
    seed_everything,
    snapshot_sources,
    synthetic_skeleton_batches,
)
from interdiff_torch.data.paths import load_paths
from interdiff_torch.models.correction import ObjProjectorSkeleton
from interdiff_torch.parallel.mesh import (
    DataMesh,
    is_rank0,
    make_mesh,
    process_device,
    replicated,
)
from interdiff_torch.train.trainer import (
    CorrectionTrainState,
    adam,
    data_parallel_step,
    make_correction_skeleton_train_step,
)

KEYS = ("skeleton", "poses")
SNAPSHOT = ("interdiff_torch.models.correction",
            "interdiff_torch.train.losses_correction")
Batch = Dict[str, np.ndarray]


def train(projector: ObjProjectorSkeleton,
          epoch_batches: Callable[[], Iterable[Batch]], *, results_dir: str,
          epochs: int = 1, lr: float = 3e-4,
          generator: Optional[torch.Generator] = None,
          on_step: Optional[Callable] = None,
          profiler: Optional[TrainProfiler] = None,
          mesh: Optional[DataMesh] = None
          ) -> Tuple[CorrectionTrainState, Dict]:
    """The training loop (`interdiff_tpu/cli/train_correction_skeleton.py:
    96-118`) on the projector's device over ``epoch_batches()`` (raw
    batches with ``skeleton`` [B,T,21,3] and ``poses`` [B,T,7]; numpy).
    With a data ``mesh``, rank 0's weights go to every rank and each steps
    its rows through `data_parallel_step`.  Returns (the final state,
    {"steps", "loss"})."""
    replicated(projector, mesh)
    state = CorrectionTrainState.create(projector, adam(lr))
    step = make_correction_skeleton_train_step(projector)
    if mesh is not None:
        step = data_parallel_step(step, mesh, extra_args=2)
    return correction_train_loop(
        projector, state, lambda epoch: step, epoch_batches, KEYS,
        results_dir=results_dir, epochs=epochs, ckpt_every=40,
        generator=generator, on_step=on_step, log=("loss",),
        profiler=profiler, mesh=mesh)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--motion_path", default=None,
                        help="directory of HO-GCN sequence pickles")
    parser.add_argument("--results_dir",
                        default="./results/skeleton_correction")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--past_len", type=int, default=10)
    parser.add_argument("--future_len", type=int, default=10)
    parser.add_argument("--seed", type=int, default=233)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic batches (no dataset)")
    parser.add_argument("--config", default=None,
                        help="YAML path config (BEHAVE.yml/HOI.yml style; "
                             "needs PyYAML): its motion path")
    add_profiler_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def main(argv=None) -> Tuple[Optional[CorrectionTrainState], Dict]:
    """Parse the flags and train on one rank a visible card
    (`cli/common.py::launch_trainer`)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.config:
        args.motion_path = args.motion_path or load_paths(
            args.config).motion_path
    if not args.synthetic and not args.motion_path:
        parser.error("--motion_path is required unless --synthetic is set")
    device = resolve_device(None if args.device == "cuda" else args.device)
    return launch_trainer(run, args, device)


def run(args, device) -> Tuple[Optional[CorrectionTrainState], Dict]:
    """One rank of :func:`main` (the whole run at one rank)."""
    device = process_device(device)
    rng = seed_everything(args.seed)
    mesh = make_mesh(batch_size=args.batch_size, device=device)
    if mesh is None:  # a rank the batch's divisor rule leaves out
        return None, {}
    T = args.past_len + args.future_len
    projector = ObjProjectorSkeleton(past_len=args.past_len,
                                     future_len=args.future_len,
                                     device=device)
    if is_rank0(mesh):
        snapshot_sources(args.results_dir, SNAPSHOT)
    epochs = args.epochs
    if args.synthetic:
        epochs = 1  # one epoch, whatever --epochs

        def epoch_batches():
            return synthetic_skeleton_batches(
                rng, batch_size=args.batch_size, seq_len=T,
                steps=args.synthetic)
    else:
        from interdiff_torch.data.skeleton import (
            collate_skeleton,
            load_skeleton_datasets,
        )

        train_split, _, _, _ = load_skeleton_datasets(args.motion_path)

        def epoch_batches():
            return batch_iterator(train_split, collate_skeleton,
                                  batch_size=args.batch_size, rng=rng)

    return train(projector, epoch_batches, results_dir=args.results_dir,
                 epochs=epochs, lr=args.lr,
                 generator=torch.Generator(device=device).manual_seed(
                     args.seed),
                 profiler=TrainProfiler.from_args(args, args.results_dir,
                                                  device)
                 if is_rank0(mesh) else None, mesh=mesh)


if __name__ == "__main__":
    main()
