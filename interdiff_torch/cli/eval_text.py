"""MDM text-to-motion sampling on HumanML3D's layout (github.com/GuyTevet/
motion-diffusion-model `sample/generate.py`; the sampling of
`eval/eval_humanml.py`): captions as CLIP token ids, CLIP's text tower
once a batch, 1000 guided DDPM steps over the motion, HumanML3D's
`recover_from_ric` to joints.

Usage:
  python -m interdiff_torch.cli.eval_text --synthetic N [--batch_size 32] \\
      [--respacing 100] [--guidance_param 2.5] [--out joints.npz] \\
      [--diffusion_ckpt model.pt] [--device cpu]
  python -m interdiff_torch.cli.eval_text --ids ids.npy ...

``--ids`` reads an int array [N, 77] of caption ids in the layout of
`eval/text.py::caption_ids` (SOT, tokens, EOT, zeros); ``--synthetic N``
samples N batches of captions of 6-20 random token ids instead.  The BPE
tokenizer, MDM's trained checkpoint, CLIP's weights and HumanML3D's
normalisation statistics are not in the repository: the weights are the
modules' seeded initial ones unless ``--diffusion_ckpt`` names a state
dict of `MDMText` (`utils/convert.py::save_state_dict`), and the features
are taken as normalised by the identity.  It runs on the CUDA device
unless ``--device`` names another.

``main`` builds the objects from the flags; ``evaluate`` is the loop itself,
on any model and iterator of batches.
"""

from __future__ import annotations

import functools
from argparse import ArgumentParser
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.cli.common import load_weights, seed_everything
from interdiff_torch.config import DiffusionConfig, TextTrackConfig
from interdiff_torch.diffusion.gaussian import GaussianDiffusion
from interdiff_torch.eval.text import (
    TextEvalConfig,
    caption_ids,
    make_text_sampler,
    motion_stats,
)
from interdiff_torch.geometry.humanml import recover_from_ric
from interdiff_torch.models.mdm_text import MDMText
from interdiff_torch.utils import profiling

Noises = Iterator[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _print_running(nb: int, running: Dict[str, float]) -> None:
    print({k: round(v, 5) for k, v in running.items()}, flush=True)


def evaluate(cfg: TextEvalConfig, model: MDMText,
             diffusion: GaussianDiffusion,
             batches: Iterable[Dict[str, np.ndarray]], *,
             generator: Optional[torch.Generator] = None,
             noises: Optional[Noises] = None,
             report: Callable[[int, Dict[str, float]], None] = _print_running,
             timings: Optional[Dict[str, float]] = None,
             motions: Optional[List[Dict[str, torch.Tensor]]] = None
             ) -> Tuple[Dict[str, float], int]:
    """The sampling loop on the model's device; returns (the sum over
    batches of each of `motion_stats`, the number of batches).

    Per batch (``ids`` [B, context], numpy or a tensor): the pooled text
    once (part ``encode``), one guided sampler call (``sampler``),
    `recover_from_ric` (``postprocess``), and ``report(batches so far,
    running means)`` after one read of the device.  ``motions`` receives
    each batch's ``sample`` [B, frames, 263] and ``joints`` [B, frames,
    22, 3].  The noise is drawn from ``generator`` unless ``noises``
    yields one ``(noise, step_noise)`` pair a batch.  ``timings`` collects
    each part's wall seconds with a device synchronisation around it and
    opens a session of `utils/profiling.py` unless one is open; every
    batch is a span ``eval.batch`` holding the parts' spans
    ``eval.<part>``."""
    device = next(model.parameters()).device
    sample = make_text_sampler(cfg, model, diffusion)
    timed = functools.partial(profiling.timed, timings, device)
    cuda = device.type == "cuda"
    totals: Dict[str, float] = {}
    nb = 0
    with torch.no_grad(), profiling.session(timings is not None):
        for batch in batches:
            with profiling.span("eval.batch", cuda=cuda, cpu=True, b=nb):
                ids = torch.as_tensor(batch["ids"], device=device)
                text = timed("eval.encode", model.encode_text, ids)
                noise, step_noise = (None, None) if noises is None \
                    else next(noises)
                x = timed("eval.sampler", sample, text, noise=noise,
                          step_noise=step_noise, generator=generator)
                joints = timed("eval.postprocess", recover_from_ric, x,
                               cfg.num_joints)
                if motions is not None:
                    motions.append({"sample": x, "joints": joints})
                m = motion_stats(joints)
                nb += 1
                values = torch.stack(list(m.values())).tolist()
                for k, v in zip(m, values):
                    totals[k] = totals.get(k, 0.0) + v
                report(nb, {k: v / nb for k, v in totals.items()})
    return totals, nb


def synthetic_captions(rng: np.random.Generator, *, batch_size: int,
                       steps: int, vocab_size: int = 49408,
                       context_length: int = 77
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """``steps`` batches of captions of 6-20 token ids drawn uniformly from
    [1, vocab_size - 3]."""
    for _ in range(steps):
        lengths = rng.integers(6, 21, batch_size)
        tokens = [rng.integers(1, vocab_size - 2, n) for n in lengths]
        yield {"ids": caption_ids(tokens, vocab_size=vocab_size,
                                  context_length=context_length)}


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ids", default=None,
                        help=".npy of caption ids [N, 77] (SOT, tokens, "
                             "EOT, zeros)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="sample N batches of random captions")
    parser.add_argument("--diffusion_ckpt", default=None,
                        help="state dict of MDMText (save_state_dict)")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--num_frames", type=int, default=196)
    parser.add_argument("--guidance_param", type=float, default=2.5)
    parser.add_argument("--seed", type=int, default=10)
    parser.add_argument("--respacing", default="",
                        help="timestep respacing, e.g. '100'")
    parser.add_argument("--out", default=None,
                        help="write the joints [N, frames, 22, 3] here "
                             "(.npz, key 'joints')")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def main(argv=None) -> Tuple[Dict[str, float], int]:
    parser = build_parser()
    args = parser.parse_args(argv)
    if bool(args.ids) == bool(args.synthetic):
        parser.error("give one of --ids and --synthetic")
    device = resolve_device(None if args.device == "cuda" else args.device)
    rng = seed_everything(args.seed)
    track = TextTrackConfig(
        diffusion=DiffusionConfig(timestep_respacing=args.respacing))
    model = track.build_model(device)
    load_weights(model, args.diffusion_ckpt)
    diffusion = track.diffusion.build(device)
    cfg = TextEvalConfig(num_frames=args.num_frames,
                         guidance_param=args.guidance_param)
    if args.ids:
        ids = np.load(args.ids)
        if ids.ndim != 2 or ids.shape[1] != track.context_length:
            parser.error(f"--ids: expected [N, {track.context_length}] ids, "
                         f"got {list(ids.shape)}")
        batches = ({"ids": ids[i:i + args.batch_size]}
                   for i in range(0, len(ids), args.batch_size))
    else:
        batches = synthetic_captions(
            rng, batch_size=args.batch_size, steps=args.synthetic,
            vocab_size=track.vocab_size,
            context_length=track.context_length)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    motions: List[Dict[str, torch.Tensor]] = []
    out = evaluate(cfg, model, diffusion, batches, generator=generator,
                   motions=motions if args.out else None)
    if args.out:
        np.savez(args.out, joints=torch.cat(
            [m["joints"] for m in motions]).cpu().numpy())
        print("wrote", args.out, flush=True)
    return out


if __name__ == "__main__":
    main()
