"""Train the SMPL-track correction network, `ObjProjectorSmpl`
(`interdiff_tpu/cli/train_correction_smpl.py`, the reference's
`interdiff/train_correction_smpl.py`): Adam at lr 3e-4, the 8 pose terms
plus contact and penetration with epoch annealing, and the mean-marker
``initialize`` phase for the first 10 epochs.

Usage:
  python -m interdiff_torch.cli.train_correction_smpl --motion_path DIR \\
      --model_path <SMPLH pkl dir> [--epochs 500] [--batch_size 16] \\
      [--lr 3e-4] [--w_contact 1.0] [--w_penetration 0.1] \\
      [--results_dir DIR] [--device cpu]
  python -m interdiff_torch.cli.train_correction_smpl --synthetic N_steps ...

``--profiler simple`` prints the seconds of the sections ``batch_place``
and ``train_step`` at the end, ``--profiler trace`` writes a
`torch.profiler` trace to ``<results_dir>/trace``, ``--debug_nan`` turns on
torch's anomaly detection with NaN checks.

It runs on the CUDA device unless ``--device`` names another; without a CUDA
device and without ``--device`` it stops.  The dataset route trains on the
train split of ``--motion_path`` with every field of a clip (markers, body
vertices, the object's points), the corpus read once and its clips
shuffled and jittered anew every epoch; the first 10 epochs take the
mean-marker phase (``--config`` may name both paths, ``--synthetic_body``
stands in for the pkls).  ``--synthetic N`` trains on N random batches
(``--synthetic_verts`` body vertices, ``--synthetic_points`` object
points), one epoch in the main phase, as the JAX package's ``--synthetic``
does.  ``--render_interval N`` renders, every N epochs, the predicted and
the ground-truth object trajectory of the epoch's last batch's first clip
beside its body as two gifs in ``<results_dir>/render`` (the reference's
validation renders); it needs the body's faces, so ``--synthetic`` ignores
it, as the JAX package does.

Data parallelism as in `cli/train_diffusion_smpl.py`: one rank a visible
card (or a torchrun process), the mesh, built after the corpus-fitted batch
size, over the largest count of ranks that divides it,
`train/trainer.py::data_parallel_step`, rank 0 alone rendering and
writing.

``main`` builds the objects from the flags; ``train`` is the loop itself, on
any projector and any source of batches.  It writes ``<results_dir>/ckpt/``
(the projector's state dict, BatchNorm statistics included, every 25 epochs
and after the last) and ``metrics.jsonl``.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.cli.common import (
    add_data_args,
    batch_iterator,
    check_data_args,
    check_render_interval,
    render_body_object,
    TrainProfiler,
    add_profiler_args,
    correction_train_loop,
    fit_batch_size,
    launch_trainer,
    load_smpl_models,
    seed_everything,
    snapshot_sources,
    synthetic_smpl_batches,
)
from interdiff_torch.data.behave import (
    BehaveDataset,
    collate,
    load_behave_sequences,
)
from interdiff_torch.geometry.rotations import (
    axis_angle_to_matrix,
    matrix_to_rotation_6d,
    rotation_6d_to_matrix,
)
from interdiff_torch.models.correction import ObjProjectorSmpl
from interdiff_torch.parallel.mesh import (
    DataMesh,
    is_rank0,
    make_mesh,
    process_device,
    replicated,
)
from interdiff_torch.train.losses_correction import CorrectionLossWeights
from interdiff_torch.train.trainer import (
    CorrectionTrainState,
    adam,
    data_parallel_step,
    make_correction_smpl_train_step,
)

KEYS = ("obj_angles", "obj_trans", "markers", "human_verts", "obj_points")
SNAPSHOT = ("interdiff_torch.models.correction",
            "interdiff_torch.train.losses_correction")
Batch = Dict[str, np.ndarray]


def make_correction_render(projector: ObjProjectorSmpl, faces: np.ndarray,
                           results_dir: str) -> Callable:
    """``render(epoch, batch)``: the projector's eval-mode correction of the
    batch's first clip (the ground-truth object pose and markers, the
    contact counts of the future frames) and the ground truth, each as a
    gif of the object's template cloud beside the body
    (`interdiff_tpu/cli/train_correction_smpl.py:159-230`):
    ``<results_dir>/render/epoch<e>_{pred,gt}.gif``."""
    device = next(projector.parameters()).device
    past_len = projector.past_len

    @torch.no_grad()
    def render(epoch: int, batch: Batch) -> None:
        b = {k: torch.as_tensor(batch[k][:1], device=device) for k in KEYS}
        markers = b["markers"]
        contact = markers[:, past_len:, :, 6].sum(dim=1)
        obj_gt = torch.cat([matrix_to_rotation_6d(axis_angle_to_matrix(
            b["obj_angles"])), b["obj_trans"]], dim=-1)
        obj_pred = projector.sample(obj_gt, markers[..., :3], contact,
                                    train=False)
        body = b["human_verts"][0, :, :, :3].cpu().numpy()
        tpl = b["obj_points"][0, :, :3].cpu().numpy()
        for tag, pose in (("pred", obj_pred), ("gt", obj_gt)):
            render_body_object(
                os.path.join(results_dir, "render",
                             f"epoch{epoch}_{tag}.gif"),
                body, faces, rotation_6d_to_matrix(pose[0, :, :6]).cpu()
                .numpy(), pose[0, :, 6:9].cpu().numpy(), tpl, None,
                past_len=past_len)

    return render


def train(projector: ObjProjectorSmpl,
          epoch_batches: Callable[[], Iterable[Batch]], *, results_dir: str,
          epochs: int = 1, lr: float = 3e-4,
          weights: Optional[CorrectionLossWeights] = None,
          initialize_epochs: int = 10,
          generator: Optional[torch.Generator] = None,
          on_step: Optional[Callable] = None,
          profiler: Optional[TrainProfiler] = None,
          render_interval: int = 0,
          render_faces: Optional[np.ndarray] = None,
          mesh: Optional[DataMesh] = None
          ) -> Tuple[CorrectionTrainState, Dict]:
    """The training loop (`interdiff_tpu/cli/train_correction_smpl.py:190-
    262`) on the projector's device: epochs below ``initialize_epochs`` take
    the ``initialize`` step (the mean over nodes), the rest the main step;
    the annealing reads the epoch.  ``epoch_batches()`` yields one epoch of
    raw batches (``obj_angles`` / ``obj_trans`` [B,T,3], ``markers``
    [B,T,67,7], ``human_verts`` [B,T,V,7], ``obj_points`` [B,P,>=3]; numpy).
    The marker draws (and dropout) come from ``generator``.  Every
    ``render_interval`` epochs (none at 0) `make_correction_render` draws
    the epoch's last batch on the body faces ``render_faces``.  With a data
    ``mesh``, rank 0's weights go to every rank, each steps its rows
    through `data_parallel_step`, and rank 0 alone renders.  Returns (the
    final state, {"steps", "loss"})."""
    on_epoch = None
    if render_interval:
        if render_faces is None:
            raise ValueError("render_interval needs the body's faces")
        render = make_correction_render(projector, render_faces, results_dir)

        def on_epoch(epoch, batch, state):
            if (epoch + 1) % render_interval == 0:
                if batch is None:
                    print("render skipped: no batches this epoch",
                          flush=True)
                else:
                    render(epoch, batch)

    replicated(projector, mesh)
    state = CorrectionTrainState.create(projector, adam(lr))
    steps = {phase: make_correction_smpl_train_step(
        projector, weights=weights, initialize=phase)
        for phase in (True, False)}
    if mesh is not None:
        steps = {phase: data_parallel_step(step, mesh, extra_args=2)
                 for phase, step in steps.items()}
    return correction_train_loop(
        projector, state, lambda epoch: steps[epoch < initialize_epochs],
        epoch_batches, KEYS, results_dir=results_dir, epochs=epochs,
        ckpt_every=25, generator=generator, on_step=on_step,
        profiler=profiler, on_epoch=on_epoch, mesh=mesh)


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--results_dir", default="./results/smpl_correction")
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--dct", type=int, default=10)
    parser.add_argument("--past_len", type=int, default=10)
    parser.add_argument("--future_len", type=int, default=25)
    parser.add_argument("--seed", type=int, default=233)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic batches (no dataset)")
    parser.add_argument("--synthetic_verts", type=int, default=64,
                        help="body vertices per synthetic frame")
    parser.add_argument("--synthetic_points", type=int, default=512,
                        help="object points per synthetic batch")
    parser.add_argument("--w_contact", type=float, default=None,
                        help="contact loss weight (default: the "
                             "reference's 1.0)")
    parser.add_argument("--w_penetration", type=float, default=None,
                        help="penetration loss weight (default: the "
                             "reference's 0.1)")
    parser.add_argument("--render_interval", type=int, default=0,
                        help="render pred-vs-gt object-trajectory mesh gifs "
                             "of sample 0 every N epochs into "
                             "<results_dir>/render; needs real data (body "
                             "faces), ignored under --synthetic")
    add_profiler_args(parser)
    add_data_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def main(argv=None) -> Tuple[Optional[CorrectionTrainState], Dict]:
    """Parse the flags and train on one rank a visible card
    (`cli/common.py::launch_trainer`)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_data_args(parser, args)
    check_render_interval(parser, args.render_interval)
    device = resolve_device(None if args.device == "cuda" else args.device)
    return launch_trainer(run, args, device)


def run(args, device) -> Tuple[Optional[CorrectionTrainState], Dict]:
    """One rank of :func:`main` (the whole run at one rank)."""
    device = process_device(device)
    rng = seed_everything(args.seed)
    T = args.past_len + args.future_len
    projector = ObjProjectorSmpl(n_pre=args.dct, past_len=args.past_len,
                                 future_len=args.future_len, device=device)
    defaults = CorrectionLossWeights()
    weights = CorrectionLossWeights(
        contact=defaults.contact if args.w_contact is None
        else args.w_contact,
        penetration=defaults.penetration if args.w_penetration is None
        else args.w_penetration)

    render_faces, batch_size = None, args.batch_size
    if args.synthetic:
        if args.render_interval:
            print("--render_interval needs real data (body faces); ignored "
                  "under --synthetic", flush=True)

        def epoch_batches():
            return synthetic_smpl_batches(
                rng, batch_size=args.batch_size, seq_len=T,
                num_points=args.synthetic_points,
                num_verts=args.synthetic_verts, steps=args.synthetic)
    else:
        # the corpus is read once; the window jitter is drawn per clip, so
        # one dataset serves every epoch
        smpl_models = load_smpl_models(args, device)
        render_faces = smpl_models["male"].faces
        ds = BehaveDataset(load_behave_sequences(
            args.motion_path, smpl_models=smpl_models,
            mode="train"), past_len=args.past_len,
            future_len=args.future_len, rng=rng)
        batch_size = fit_batch_size(len(ds), args.batch_size)

        def epoch_batches():
            return batch_iterator(ds, collate, batch_size=batch_size,
                                  rng=rng)

    # the mesh after the corpus-fitted batch size: the ranks must divide it
    mesh = make_mesh(batch_size=batch_size, device=device)
    if mesh is None:  # a rank the batch's divisor rule leaves out
        return None, {}
    if is_rank0(mesh):
        snapshot_sources(args.results_dir, SNAPSHOT)
    # a synthetic run is one epoch of the main phase, whatever --epochs
    return train(projector, epoch_batches, results_dir=args.results_dir,
                 epochs=1 if args.synthetic else args.epochs, lr=args.lr,
                 weights=weights,
                 initialize_epochs=0 if args.synthetic else 10,
                 generator=torch.Generator(device=device).manual_seed(
                     args.seed),
                 profiler=TrainProfiler.from_args(args, args.results_dir,
                                                  device)
                 if is_rank0(mesh) else None,
                 render_interval=0 if args.synthetic
                 else args.render_interval,
                 render_faces=render_faces, mesh=mesh)


if __name__ == "__main__":
    main()
