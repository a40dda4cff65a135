"""SMPL-track short-term evaluation (`interdiff_tpu/cli/eval_smpl_short.py`,
the reference's `interdiff/eval_smpl_short.py`): best-of-`diverse_samples`
metrics, with the physics-informed correction in the sampling loop unless
``--mode no_correction``.

Usage:
  python -m interdiff_torch.cli.eval_smpl_short --motion_path DIR \\
      --model_path <SMPLH pkl dir> [--mode correction] \\
      [--diverse_samples 10] [--sampler ddpm] [--diffusion_ckpt model.pt] \\
      [--correction_ckpt projector.pt] [--device cpu]
  python -m interdiff_torch.cli.eval_smpl_short --synthetic N ...

It runs on the CUDA device unless ``--device`` names another; without a CUDA
device and without ``--device`` it stops.  The dataset route reads the test
split of ``--motion_path`` (the train split when it has no Date03*
sequence; ``--config`` may name both paths, ``--synthetic_body`` stands in
for the pkls) and scores every clip on the male body, as the JAX CLI does.
The checkpoints are state dicts written by
`utils/convert.py::save_state_dict`; without them the weights are the
modules' seeded initial ones.  Rendering (``--render_dir``, ``--obj_mesh``)
is not ported yet and stops with an error; several devices
(``--mesh_devices``) are not ported, and the parser does not know the flag.

``main`` builds the objects from the flags; ``evaluate`` is the loop itself,
on any body, models and iterator of batches.
"""

from __future__ import annotations

import time
from argparse import ArgumentParser
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.cli.common import (
    add_data_args,
    batch_iterator,
    check_data_args,
    fit_batch_size,
    load_eval_sequences,
    load_smpl_models,
    load_weights,
    seed_everything,
    synthetic_smpl_batches,
    synthetic_smpl_body,
)
from interdiff_torch.config import (
    CorrectionConfig,
    DiffusionConfig,
    SmplTrackConfig,
)
from interdiff_torch.data.behave import BehaveDataset, collate
from interdiff_torch.data.constants import MARKERSET_SSM67_SMPLH
from interdiff_torch.diffusion.gaussian import GaussianDiffusion
from interdiff_torch.eval.metrics import smpl_metrics
from interdiff_torch.eval.smpl_short import (
    SmplEvalConfig,
    make_sampler,
    postprocess_sample,
)
from interdiff_torch.models.correction import ObjProjectorSmpl
from interdiff_torch.models.mdm_smpl import MDMSmpl, smpl_gt_from_raw
from interdiff_torch.parallel.sample_parallel import (
    best_of_n_metrics,
    tile_for_diverse_samples,
)
from interdiff_torch.smpl.model import SmplModel

Noises = Iterator[Tuple[torch.Tensor, Optional[torch.Tensor]]]


def _print_running(nb: int, running: Dict[str, float]) -> None:
    print(nb, {k: round(v, 5) for k, v in running.items()}, flush=True)


def evaluate(cfg: SmplEvalConfig, model: MDMSmpl,
             diffusion: GaussianDiffusion, smpl: SmplModel,
             batches: Iterable[Dict[str, np.ndarray]], *,
             projector: Optional[ObjProjectorSmpl] = None,
             diverse_samples: int = 10, diverse_fold: int = 2,
             sampler: str = "ddpm",
             metrics_prune_delta: Optional[float] = None,
             markers_idx: Optional[np.ndarray] = None,
             generator: Optional[torch.Generator] = None,
             noises: Optional[Noises] = None,
             report: Callable[[int, Dict[str, float]], None] = _print_running,
             timings: Optional[Dict[str, float]] = None
             ) -> Tuple[Dict[str, float], int]:
    """The evaluation loop (`interdiff_tpu/cli/eval_smpl_short.py:263-311`)
    on the model's device; returns (the sum over batches of each metric's
    batch mean, the number of batches).

    Per batch (``body_pose`` [B,T,156], ``body_trans``, ``obj_angles``,
    ``obj_trans`` [B,T,3], ``obj_points`` [B,P,>=6], optional ``body_betas``
    [B,T,10]; numpy or tensors): encode once, gt FK once on the untiled
    batch, tile by ``diverse_fold``, then ``diverse_samples / diverse_fold``
    sampler calls, each followed by `postprocess_sample` and `smpl_metrics`
    on the future frames; the minimum over all diverse samples of a clip,
    the mean over the clips, and ``report(batches so far, running means)``.

    With ``projector`` the correction runs in the loop.  The sampling noise
    is drawn from ``generator`` unless ``noises`` yields one
    ``(noise, step_noise)`` pair per sampler call (replay across devices and
    packages).  ``timings`` collects the wall seconds of each part, with a
    device synchronisation around every part (none without it).
    """
    if diverse_fold < 1 or diverse_samples % diverse_fold:
        raise ValueError("diverse_fold must be positive and divide "
                         "diverse_samples")
    device = next(model.parameters()).device
    sample = make_sampler(
        cfg, model, diffusion, smpl=smpl, projector=projector,
        use_correction=projector is not None, markers_idx=markers_idx,
        reuse_memory=True, sampler=sampler)
    p = cfg.past_len

    def timed(part: str, fn, *args, **kwargs):
        if timings is None:
            return fn(*args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[part] = timings.get(part, 0.0) + time.perf_counter() - t0
        return out

    def metrics(out, gt_post, obj_pts3):
        return smpl_metrics(
            out["obj_pred"][:, p:], out["jtr"][:, p:],
            out["body_pred"][:, p:], gt_post["obj_pred"][:, p:],
            gt_post["jtr"][:, p:], gt_post["body_pred"][:, p:],
            out["verts"][:, p:], smpl.faces_idx, obj_pts3,
            nn_prune_delta=metrics_prune_delta, incident=smpl.incident)

    totals: Dict[str, float] = {}
    nb = 0
    with torch.no_grad():
        for batch in batches:
            b = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()
                 if k in ("body_pose", "body_trans", "obj_angles",
                          "obj_trans", "obj_points", "body_betas")}
            gt = smpl_gt_from_raw(b["body_pose"][..., :66], b["body_trans"],
                                  b["obj_angles"], b["obj_trans"])
            obj_points6 = b["obj_points"][..., :6]
            hand = b["body_pose"][..., 66:]
            betas = b["body_betas"] if "body_betas" in b else gt.new_zeros(
                gt.shape[:2] + (10,))

            memory = timed("encode", model.encode, gt, obj_points6)
            # ground-truth FK once on the untiled batch: it is deterministic
            gt_post = timed("postprocess", postprocess_sample, cfg, smpl, gt,
                            hand, betas)
            if diverse_fold > 1:
                gt, obj_points6, hand, betas, memory = \
                    tile_for_diverse_samples(
                        (gt, obj_points6, hand, betas, memory), diverse_fold)
                gt_post = {k: tile_for_diverse_samples(v, diverse_fold)
                           for k, v in gt_post.items()}
            best = None
            for _ in range(diverse_samples // diverse_fold):
                noise, step_noise = (None, None) if noises is None \
                    else next(noises)
                x = timed("sampler", sample, gt, obj_points6, hand, betas,
                          memory, noise=noise, step_noise=step_noise,
                          generator=generator)
                out = timed("postprocess", postprocess_sample, cfg, smpl, x,
                            hand, betas)
                m = timed("metrics", metrics, out, gt_post,
                          obj_points6[..., :3])
                m = best_of_n_metrics(m, diverse_fold)
                best = m if best is None else {
                    k: torch.minimum(best[k], m[k]) for k in m}
            nb += 1
            # one read of the device per batch
            means = torch.stack([v.mean() for v in best.values()]).tolist()
            for k, v in zip(best, means):
                totals[k] = totals.get(k, 0.0) + v
            report(nb, {k: v / nb for k, v in totals.items()})
    return totals, nb


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--diffusion_ckpt", default=None,
                        help="state dict of MDMSmpl (save_state_dict)")
    parser.add_argument("--correction_ckpt", default=None,
                        help="state dict of ObjProjectorSmpl")
    parser.add_argument("--mode", default="correction",
                        choices=["correction", "no_correction"])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--diverse_samples", type=int, default=10)
    parser.add_argument("--diverse_fold", type=int, default=2,
                        help="diverse samples folded into the batch axis per "
                             "sampling call (must divide --diverse_samples)")
    parser.add_argument("--past_len", type=int, default=10)
    parser.add_argument("--future_len", type=int, default=25)
    parser.add_argument("--seed", type=int, default=233)
    parser.add_argument("--respacing", default="",
                        help="timestep respacing, e.g. '100' or 'ddim50'")
    parser.add_argument("--sampler", default="ddpm",
                        choices=["ddpm", "ddim", "plms"])
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate N synthetic batches on the synthetic "
                             "stand-in body (no dataset, no pkl)")
    parser.add_argument("--nn_prune_delta", type=float, default=0.25,
                        help="pruning radius of the gate's object->body "
                             "sweep (the same gate decisions while it "
                             "exceeds the body's largest interior-to-vertex "
                             "distance, about 0.17 m); <= 0 sweeps in full")
    parser.add_argument("--metrics_prune_delta", type=float, default=0.0,
                        help="opt-in pruning radius of the penetrate "
                             "metric's sweep; 0 keeps the reference's full "
                             "sweep (pruning is faster and closer to the "
                             "geometric truth but changes the number)")
    add_data_args(parser)
    parser.add_argument("--render_dir", default=None, help="not ported yet")
    parser.add_argument("--obj_mesh", default=None, help="not ported yet")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def main(argv=None) -> Tuple[Dict[str, float], int]:
    parser = build_parser()
    args = parser.parse_args(argv)
    # the fold flags first, before anything is built
    if args.diverse_fold < 1:
        parser.error("--diverse_fold must be a positive integer")
    if args.diverse_samples % args.diverse_fold:
        parser.error("--diverse_fold must divide --diverse_samples")
    unported = [f"--{n}" for n in ("render_dir", "obj_mesh")
                if getattr(args, n) is not None]
    if unported:
        parser.error(f"{', '.join(unported)}: rendering is not ported yet")
    check_data_args(parser, args)
    device = resolve_device(None if args.device == "cuda" else args.device)

    rng = seed_everything(args.seed)
    cfg = SmplEvalConfig(
        past_len=args.past_len, future_len=args.future_len,
        nn_prune_delta=args.nn_prune_delta if args.nn_prune_delta > 0
        else None)
    track = SmplTrackConfig(
        past_len=args.past_len, future_len=args.future_len,
        diffusion=DiffusionConfig(timestep_respacing=args.respacing))
    model = track.build_model(device)
    load_weights(model, args.diffusion_ckpt)
    diffusion = track.diffusion.build(device)

    projector = None
    if args.mode == "correction":
        projector = CorrectionConfig(
            past_len=args.past_len,
            future_len=args.future_len).build_model(device)
        load_weights(projector, args.correction_ckpt)

    # the body first, then the batches, from the one generator: the order
    # of the JAX package's CLI
    if args.synthetic:
        smpl = synthetic_smpl_body(rng, device=device)
        batches = synthetic_smpl_batches(
            rng, batch_size=args.batch_size, seq_len=cfg.seq_len,
            num_points=512, steps=args.synthetic)
    else:
        smpl_models = load_smpl_models(args, device)
        smpl = smpl_models["male"]  # one body for every clip, as in JAX
        # light fields: the loop reads the pose streams and the template
        # cloud only (contacts are recomputed in the loop)
        ds = BehaveDataset(load_eval_sequences(args.motion_path, smpl_models),
                           past_len=args.past_len,
                           future_len=args.future_len, rng=rng,
                           fields="light")
        batches = batch_iterator(
            ds, collate, batch_size=fit_batch_size(len(ds), args.batch_size),
            rng=rng, shuffle=False)
    # the stand-in body has fewer vertices than the marker set's largest
    # index; the JAX package's gather clamps such indices, so do the same
    markers_idx = np.minimum(MARKERSET_SSM67_SMPLH, smpl.num_verts - 1)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    return evaluate(
        cfg, model, diffusion, smpl, batches, projector=projector,
        diverse_samples=args.diverse_samples, diverse_fold=args.diverse_fold,
        sampler=args.sampler,
        metrics_prune_delta=args.metrics_prune_delta
        if args.metrics_prune_delta > 0 else None,
        markers_idx=markers_idx, generator=generator)


if __name__ == "__main__":
    main()
