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

It runs on the CUDA device unless ``--device`` names another; without a CUDA
device and without ``--device`` it stops.  The dataset route trains on the
train split of ``--motion_path`` with every field of a clip (markers, body
vertices, the object's points), the corpus read once and its clips
shuffled and jittered anew every epoch; the first 10 epochs take the
mean-marker phase (``--config`` may name both paths, ``--synthetic_body``
stands in for the pkls).  ``--synthetic N`` trains on N random batches
(``--synthetic_verts`` body vertices, ``--synthetic_points`` object
points), one epoch in the main phase, as the JAX package's ``--synthetic``
does.  The validation renders (``--render_interval``) are not ported yet
and stop with an error.

``main`` builds the objects from the flags; ``train`` is the loop itself, on
any projector and any source of batches.  It writes ``<results_dir>/ckpt/``
(the projector's state dict, BatchNorm statistics included, every 25 epochs
and after the last) and ``metrics.jsonl``.
"""

from __future__ import annotations

from argparse import ArgumentParser
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.cli.common import (
    add_data_args,
    batch_iterator,
    check_data_args,
    correction_train_loop,
    fit_batch_size,
    load_smpl_models,
    seed_everything,
    synthetic_smpl_batches,
)
from interdiff_torch.data.behave import (
    BehaveDataset,
    collate,
    load_behave_sequences,
)
from interdiff_torch.models.correction import ObjProjectorSmpl
from interdiff_torch.train.losses_correction import CorrectionLossWeights
from interdiff_torch.train.trainer import (
    CorrectionTrainState,
    adam,
    make_correction_smpl_train_step,
)

KEYS = ("obj_angles", "obj_trans", "markers", "human_verts", "obj_points")
Batch = Dict[str, np.ndarray]
UNPORTED = ("render_interval",)


def train(projector: ObjProjectorSmpl,
          epoch_batches: Callable[[], Iterable[Batch]], *, results_dir: str,
          epochs: int = 1, lr: float = 3e-4,
          weights: Optional[CorrectionLossWeights] = None,
          initialize_epochs: int = 10,
          generator: Optional[torch.Generator] = None,
          on_step: Optional[Callable] = None
          ) -> Tuple[CorrectionTrainState, Dict]:
    """The training loop (`interdiff_tpu/cli/train_correction_smpl.py:190-
    262`) on the projector's device: epochs below ``initialize_epochs`` take
    the ``initialize`` step (the mean over nodes), the rest the main step;
    the annealing reads the epoch.  ``epoch_batches()`` yields one epoch of
    raw batches (``obj_angles`` / ``obj_trans`` [B,T,3], ``markers``
    [B,T,67,7], ``human_verts`` [B,T,V,7], ``obj_points`` [B,P,>=3]; numpy).
    The marker draws (and dropout) come from ``generator``.  Returns (the
    final state, {"steps", "loss"})."""
    state = CorrectionTrainState.create(projector, adam(lr))
    steps = {phase: make_correction_smpl_train_step(
        projector, weights=weights, initialize=phase)
        for phase in (True, False)}
    return correction_train_loop(
        projector, state, lambda epoch: steps[epoch < initialize_epochs],
        epoch_batches, KEYS, results_dir=results_dir, epochs=epochs,
        ckpt_every=25, generator=generator, on_step=on_step)


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
    for name in UNPORTED:
        parser.add_argument(f"--{name}", default=None, help="not ported yet")
    add_data_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def main(argv=None) -> Tuple[CorrectionTrainState, Dict]:
    parser = build_parser()
    args = parser.parse_args(argv)
    given = [f"--{n}" for n in UNPORTED if getattr(args, n) is not None]
    if given:
        parser.error(f"{', '.join(given)}: validation renders are not "
                     "ported yet")
    check_data_args(parser, args)
    device = resolve_device(None if args.device == "cuda" else args.device)

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

    if args.synthetic:
        def epoch_batches():
            return synthetic_smpl_batches(
                rng, batch_size=args.batch_size, seq_len=T,
                num_points=args.synthetic_points,
                num_verts=args.synthetic_verts, steps=args.synthetic)
    else:
        # the corpus is read once; the window jitter is drawn per clip, so
        # one dataset serves every epoch
        ds = BehaveDataset(load_behave_sequences(
            args.motion_path, smpl_models=load_smpl_models(args, device),
            mode="train"), past_len=args.past_len,
            future_len=args.future_len, rng=rng)
        batch_size = fit_batch_size(len(ds), args.batch_size)

        def epoch_batches():
            return batch_iterator(ds, collate, batch_size=batch_size,
                                  rng=rng)

    # a synthetic run is one epoch of the main phase, whatever --epochs
    return train(projector, epoch_batches, results_dir=args.results_dir,
                 epochs=1 if args.synthetic else args.epochs, lr=args.lr,
                 weights=weights,
                 initialize_epochs=0 if args.synthetic else 10,
                 generator=torch.Generator(device=device).manual_seed(
                     args.seed))


if __name__ == "__main__":
    main()
