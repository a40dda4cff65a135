"""Test-time refinement from the command line
(`interdiff_tpu/cli/optimization.py`, the reference's
`interdiff/optimization.py` ``__main__``): 200 Adam iterations per clip.

Four modes:

* ``--motion_path DIR --model_path <SMPLH pkl dir>`` refines the
  ground-truth clips of the test split (the train split when there is no
  Date03* sequence; ``--config`` may name both paths, ``--synthetic_body``
  stands in for the pkls), ``--batch_size`` clips of one gender at a time
  on that gender's body (`refine_batch`; each clip descends as if alone),
  and reports the penetration of the future frames before and after in
  ``<out_dir>/summary.json``, each clip's result in ``clip_<i>.npz``;
* ``--synthetic N`` refines N random clips one by one (`optimize_clip`) on
  the 128-vertex stand-in body;
* either with ``--diffusion_ckpt FILE`` is the generate-then-refine
  pipeline: the SMPL sampler without correction samples the futures of the
  batches (past-frame inpainting; dataset clips on the male body, or N
  random batches on the stand-in body), every sampled clip of a batch is
  refined at once (`refine_batch`), and the penetration of the future
  frames is reported before and after in ``<out_dir>/summary.json``.
  ``FILE`` is a state dict of `MDMSmpl` (`utils/convert.py::save_state_dict`),
  a reference Lightning ``.ckpt`` (`cli/common.py::load_mdm`) or an orbax
  directory of the JAX package (``artifacts/smpl_real_params``); an empty
  string keeps the model's seeded initial weights.

Usage:
  python -m interdiff_torch.cli.optimization --motion_path DIR \\
      --model_path <SMPLH pkl dir> [--limit N] [--iters 200]
  python -m interdiff_torch.cli.optimization --synthetic 2 [--iters 200]
  python -m interdiff_torch.cli.optimization --synthetic 1 \\
      --diffusion_ckpt model.pt [--batch_size 8] [--respacing 100] \\
      [--pen_fix_body] [--ratio_denom 350] [--limit N] [--out_dir DIR] \\
      [--device cpu]

It runs on the CUDA device unless ``--device`` names another; without a CUDA
device and without ``--device`` it stops.  ``--dispatch_chunk`` is refused:
the JAX package splits its refinement into bounded dispatches to stay under
a remote TPU worker's watchdog, and the port's descent has no counterpart
(it is a Python loop of single iterations already).
"""

from __future__ import annotations

import functools
import json
import os
from argparse import ArgumentParser
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.cli.common import (
    add_data_args,
    batch_iterator,
    check_data_args,
    fit_batch_size,
    load_eval_sequences,
    load_mdm,
    load_smpl_models,
    seed_everything,
    synthetic_smpl_batches,
    synthetic_smpl_body,
)
from interdiff_torch.config import DiffusionConfig, SmplTrackConfig
from interdiff_torch.data.behave import BehaveDataset, collate
from interdiff_torch.diffusion.gaussian import GaussianDiffusion
from interdiff_torch.eval.optimization import (
    OptimConfig,
    optimize_clip,
    refine_batch,
)
from interdiff_torch.eval.smpl_short import (
    SmplEvalConfig,
    make_sampler,
    postprocess_sample,
)
from interdiff_torch.geometry.normals import vertex_normals
from interdiff_torch.geometry.rotations import axis_angle_to_matrix
from interdiff_torch.models.mdm_smpl import MDMSmpl, smpl_gt_from_raw
from interdiff_torch.ops.signed_distance import (
    safe_sqrt,
    signed_nearest_pruned,
)
from interdiff_torch.smpl.model import SmplModel, smpl_forward
from interdiff_torch.utils import profiling

PENETRATION_KEYS = ("penetrate_before", "penetrate_after", "depth_before",
                    "depth_after")


def make_penetration_fn(smpl: SmplModel, past_len: int) -> Callable:
    """``penetration(pose [B,T,156], trans [B,T,3], betas [B,T,10], obj_aa
    [B,T,3], obj_trans [B,T,3], obj_pts [B,P,3]) -> (frac [B], depth [B])``
    over the future frames: the share of object points inside the body (the
    `penetrate` metric) and the mean depth of those points, which the
    refiner's objective targets.  The sweep is K2, the pruned one: it
    consumes only signs and the depths of inside points, which pruning
    keeps exactly."""

    @torch.no_grad()
    def penetration(pose, trans, betas, obj_aa, obj_trans, obj_pts):
        B, T = pose.shape[:2]
        verts, _, _, _ = smpl_forward(smpl, pose.reshape(B * T, -1),
                                      betas.reshape(B * T, -1),
                                      trans.reshape(B * T, 3))
        rot = axis_angle_to_matrix(obj_aa)
        pts = (torch.einsum("btij,bpj->btpi", rot, obj_pts)
               + obj_trans[:, :, None])
        normals = vertex_normals(verts, smpl.faces_idx, smpl.incident)
        o2h_sq, o2h_dot = signed_nearest_pruned(pts.reshape(B * T, -1, 3),
                                                verts, normals)
        inside = (o2h_dot < 0).reshape(B, T, -1)[:, past_len:]
        frac = inside.to(torch.float32).mean(dim=(1, 2))
        depth = safe_sqrt(o2h_sq).reshape(B, T, -1)[:, past_len:]
        n_in = inside.sum(dim=(1, 2)).clamp(min=1)
        depth = torch.where(inside, depth, 0.0).sum(dim=(1, 2)) / n_in
        return frac, depth

    return penetration


def generate_and_refine(
    cfg: SmplEvalConfig, model: MDMSmpl, diffusion: GaussianDiffusion,
    smpl: SmplModel, batches: Iterable[Dict[str, np.ndarray]],
    ocfg: OptimConfig, *, out_dir: str, limit: int = 0,
    generator: Optional[torch.Generator] = None,
    timings: Optional[Dict[str, float]] = None,
    outputs: Optional[List[Dict[str, torch.Tensor]]] = None,
    extra: Optional[Dict] = None,
) -> Dict[str, float]:
    """sample -> refine -> penetration before and after
    (`interdiff_tpu/cli/optimization.py:237-375`), on the model's device.

    Per batch (``body_pose`` [B,T,156], ``body_trans``, ``obj_angles``,
    ``obj_trans`` [B,T,3], ``obj_points`` [B,P,>=6], optional
    ``body_betas``): the sampler without correction (noise from
    ``generator``), `postprocess_sample`, the penetration of the sample,
    `refine_batch` over every clip, the penetration of the refined clips;
    ``refined_<n>.npz`` under ``out_dir``.  Stops after ``limit`` batches
    (0: all).  ``timings`` collects the wall seconds of ``sample``,
    ``penetration`` and ``refine``, with a device synchronisation around
    each; ``outputs`` receives each batch's refined dict.  Returns the
    summary, the means over the batches of the four penetration numbers
    plus ``batches``, ``iters`` and ``extra``, also written to
    ``<out_dir>/summary.json``."""
    device = next(model.parameters()).device
    sample = make_sampler(cfg, model, diffusion, smpl=smpl)
    penetration = make_penetration_fn(smpl, cfg.past_len)
    os.makedirs(out_dir, exist_ok=True)

    timed = functools.partial(profiling.timed, timings, device)

    tot = dict.fromkeys(PENETRATION_KEYS, 0.0)
    nb = 0
    for batch in batches:
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
             if k in ("body_pose", "body_trans", "obj_angles", "obj_trans",
                      "obj_points", "body_betas")}
        gt = smpl_gt_from_raw(b["body_pose"][..., :66], b["body_trans"],
                              b["obj_angles"], b["obj_trans"])
        obj_points6 = b["obj_points"][..., :6]
        hand = b["body_pose"][..., 66:]
        betas = b["body_betas"] if "body_betas" in b else gt.new_zeros(
            gt.shape[:2] + (10,))
        pts3 = obj_points6[..., :3].contiguous()

        def sample_post():
            x = sample(gt, obj_points6, hand, betas, generator=generator)
            return postprocess_sample(cfg, smpl, x, hand, betas)

        out = timed("opt.sample", sample_post)
        body_pred, obj_pred = out["body_pred"], out["obj_pred"]
        frac_b, depth_b = timed(
            "opt.penetration", penetration, body_pred[..., :156],
            body_pred[..., 156:], betas, obj_pred[..., :3],
            obj_pred[..., 3:], pts3)
        refined = timed(
            "opt.refine", refine_batch, smpl, body_pose=body_pred[..., :66],
            hand_pose=body_pred[..., 66:156], body_trans=body_pred[..., 156:],
            betas=betas, obj_angles=obj_pred[..., :3],
            obj_trans=obj_pred[..., 3:], obj_points=pts3, cfg=ocfg)
        frac_a, depth_a = timed(
            "opt.penetration", penetration, refined["pose"], refined["trans"],
            betas, refined["obj_angles"], refined["obj_trans"], pts3)

        nb += 1
        # one read of the device per batch
        means = torch.stack([frac_b.mean(), frac_a.mean(), depth_b.mean(),
                             depth_a.mean(), refined["best_loss"].mean()]
                            ).tolist()
        for k, v in zip(("penetrate_before", "penetrate_after",
                         "depth_before", "depth_after"), means):
            tot[k] += v
        print(nb, {k: round(v / nb, 5) for k, v in tot.items()},
              {"best_loss": round(means[4], 5)}, flush=True)
        np.savez(os.path.join(out_dir, f"refined_{nb}.npz"),
                 **{k: v.cpu().numpy() for k, v in refined.items()})
        if outputs is not None:
            outputs.append(refined)
        if limit and nb >= limit:
            break

    summary = {k: v / max(nb, 1) for k, v in tot.items()}
    summary.update(batches=nb, iters=ocfg.iters, **(extra or {}))
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    print(json.dumps(summary), flush=True)
    return summary


def refine_dataset(smpl_models: Dict[str, SmplModel], dataset,
                   ocfg: OptimConfig, *, past_len: int, out_dir: str,
                   batch_size: int = 8, limit: int = 0,
                   timings: Optional[Dict[str, float]] = None
                   ) -> Dict[str, float]:
    """Refine ground-truth clips (`interdiff_tpu/cli/optimization.py::
    _run_dataset`, the reference's own regime) and report the penetration
    of their future frames before and after.

    ``dataset[i]`` are clips with light fields (`data/behave.py`), taken in
    order, at most ``limit`` (0: all).  Consecutive clips of one gender
    make a batch of up to ``batch_size``, refined at once on that gender's
    body by `refine_batch` (the loss is the sum over clips, so each clip
    descends as if alone, as `optimize_clip` would take it); the
    penetration before and after is one K2 sweep each per batch.  Each
    clip's result goes to ``clip_<i>.npz`` under ``out_dir``.  ``timings``
    collects the wall seconds of ``penetration`` and ``refine`` (a device
    synchronisation around each).  Returns the summary, the means over the clips of the four
    penetration numbers plus ``clips``, ``iters`` and ``mode``, also written
    to ``<out_dir>/summary.json``."""
    n = len(dataset) if not limit else min(limit, len(dataset))
    if n == 0:
        raise SystemExit("no clip windows to refine")
    os.makedirs(out_dir, exist_ok=True)
    pen_fns: Dict[str, Callable] = {}

    def refine(ids, clips, gender):
        smpl = smpl_models[gender]
        device = smpl.v_template.device
        timed = functools.partial(profiling.timed, timings, device)
        if gender not in pen_fns:
            pen_fns[gender] = make_penetration_fn(smpl, past_len)
        penetration = pen_fns[gender]

        def stack(key, cols=slice(None)):
            return torch.as_tensor(np.stack([c[key][..., cols]
                                             for c in clips]), device=device)

        body_pose, hand_pose = stack("body_pose", slice(0, 66)), \
            stack("body_pose", slice(66, None))
        trans, betas = stack("body_trans"), stack("body_betas")
        obj_aa, obj_tr = stack("obj_angles"), stack("obj_trans")
        obj_pts = stack("obj_points", slice(0, 3))
        frac_b, depth_b = timed(
            "opt.penetration", penetration,
            torch.cat([body_pose, hand_pose], dim=-1), trans, betas, obj_aa,
            obj_tr, obj_pts)
        out = timed("opt.refine", refine_batch, smpl,
                    body_pose=body_pose, hand_pose=hand_pose,
                    body_trans=trans, betas=betas, obj_angles=obj_aa,
                    obj_trans=obj_tr, obj_points=obj_pts, cfg=ocfg)
        frac_a, depth_a = timed(
            "opt.penetration", penetration, out["pose"], out["trans"],
            betas, out["obj_angles"], out["obj_trans"], obj_pts)
        # one read of the device per batch
        rows = torch.stack([frac_b, frac_a, depth_b, depth_a,
                            out["best_loss"]]).tolist()
        for k, values in zip(PENETRATION_KEYS, rows):
            tot[k] += sum(values)
        host = {k: v.cpu().numpy() for k, v in out.items()}
        for j, i in enumerate(ids):
            np.savez(os.path.join(out_dir, f"clip_{i}.npz"),
                     **{k: v[j] for k, v in host.items()})
        done = ids[-1] + 1
        print(done, {k: round(v / done, 5) for k, v in tot.items()},
              {"best_loss": [round(v, 5) for v in rows[4]]}, flush=True)

    tot = dict.fromkeys(PENETRATION_KEYS, 0.0)
    ids, clips, gender = [], [], None
    for i in range(n):
        clip = dataset[i]
        g = "male" if clip["gender"] == 0 else "female"
        if clips and (g != gender or len(clips) == batch_size):
            refine(ids, clips, gender)
            ids, clips = [], []
        ids.append(i)
        clips.append(clip)
        gender = g
    refine(ids, clips, gender)

    summary = {k: v / n for k, v in tot.items()}
    summary.update(clips=n, iters=ocfg.iters, mode="dataset")
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f)
    print(json.dumps(summary), flush=True)
    return summary


def run_synthetic(n: int, ocfg: OptimConfig, *, past_len: int,
                  future_len: int, out_dir: str, device
                  ) -> List[Dict[str, torch.Tensor]]:
    """Refine ``n`` random clips one by one on the 128-vertex stand-in
    body, the draws of the JAX package's ``_run_synthetic`` (a generator
    seeded with 233); ``synthetic_<i>.npz`` under ``out_dir``."""
    rng = np.random.default_rng(233)
    smpl = synthetic_smpl_body(rng, device=device)
    os.makedirs(out_dir, exist_ok=True)
    T = past_len + future_len

    def draw(shape, scale):
        return torch.as_tensor(
            rng.standard_normal(shape).astype(np.float32) * scale,
            device=device)

    outs = []
    for i in range(n):
        clip = {"body_pose": draw((T, 66), 0.2),
                "hand_pose": draw((T, 90), 0.05),
                "body_trans": draw((T, 3), 0.1)}
        clip["betas"] = torch.zeros((T, 10), device=device)
        clip["obj_angles"] = draw((T, 3), 0.3)
        clip["obj_trans"] = torch.zeros((T, 3), device=device)
        clip["obj_points"] = draw((64, 3), 0.05)
        out = optimize_clip(smpl, **clip, cfg=ocfg)
        np.savez(os.path.join(out_dir, f"synthetic_{i}.npz"),
                 **{k: v.cpu().numpy() for k, v in out.items()})
        print(i, "best_loss", float(out["best_loss"]), flush=True)
        outs.append(out)
    return outs


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--diffusion_ckpt", default=None,
                        help="MDMSmpl weights (a state dict, a reference "
                             "Lightning .ckpt or an orbax directory of the "
                             "JAX package): refine SAMPLED futures "
                             "and report penetration before and after ('' "
                             "keeps the seeded initial weights)")
    parser.add_argument("--past_len", type=int, default=10)
    parser.add_argument("--future_len", type=int, default=10)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--respacing", default="100",
                        help="sampling respacing of the --diffusion_ckpt "
                             "mode")
    parser.add_argument("--seed", type=int, default=233)
    parser.add_argument("--iters", type=int, default=200,
                        help="Adam iterations (`optimization.py:138`)")
    parser.add_argument("--ratio_denom", type=float, default=350.0,
                        help="penetration-weight annealing denominator "
                             "(the reference's ii/350)")
    parser.add_argument("--pen_fix_body", action="store_true",
                        help="stop the body's gradient in the penetration "
                             "term, so that only the object is pushed out")
    parser.add_argument("--dispatch_chunk", type=int, default=0,
                        help="the JAX package's bounded dispatches of the "
                             "descent; refused (no counterpart here)")
    parser.add_argument("--limit", type=int, default=0)
    parser.add_argument("--out_dir", default="./results/optimization")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="refine N synthetic clips (or, with "
                             "--diffusion_ckpt, N synthetic batches)")
    add_data_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.dispatch_chunk:
        parser.error("--dispatch_chunk: the port's descent is a Python loop "
                     "of single iterations and has no bounded dispatches "
                     "to split it into")
    check_data_args(parser, args)
    device = resolve_device(None if args.device == "cuda" else args.device)
    # keep_after below iters - 1, or the best-iterate tracker never fires
    ocfg = OptimConfig(iters=args.iters, keep_after=min(150, args.iters - 2),
                       ratio_denom=args.ratio_denom,
                       pen_fix_body=args.pen_fix_body)
    if args.diffusion_ckpt is None and args.synthetic:
        return run_synthetic(args.synthetic, ocfg, past_len=args.past_len,
                             future_len=args.future_len,
                             out_dir=args.out_dir, device=device)

    rng = seed_everything(args.seed)
    smpl_models = None if args.synthetic else load_smpl_models(args, device)
    if args.diffusion_ckpt is None:
        # the clips' own jitter generator, as in the JAX package
        ds = BehaveDataset(load_eval_sequences(args.motion_path, smpl_models),
                           past_len=args.past_len,
                           future_len=args.future_len, fields="light")
        return refine_dataset(smpl_models, ds, ocfg, past_len=args.past_len,
                              out_dir=args.out_dir,
                              batch_size=args.batch_size, limit=args.limit)

    cfg = SmplEvalConfig(past_len=args.past_len, future_len=args.future_len)
    track = SmplTrackConfig(
        past_len=args.past_len, future_len=args.future_len,
        diffusion=DiffusionConfig(timestep_respacing=args.respacing))
    model = load_mdm(args.diffusion_ckpt, "smpl", track.build_model(device),
                     past_len=args.past_len, future_len=args.future_len)
    if args.synthetic:
        smpl = synthetic_smpl_body(rng, device=device)
        batches = synthetic_smpl_batches(
            rng, batch_size=args.batch_size, seq_len=cfg.seq_len,
            num_points=256, steps=args.synthetic)
    else:
        smpl = smpl_models["male"]
        ds = BehaveDataset(load_eval_sequences(args.motion_path, smpl_models),
                           past_len=args.past_len,
                           future_len=args.future_len, rng=rng,
                           fields="light")
        batches = batch_iterator(
            ds, collate, batch_size=fit_batch_size(len(ds), args.batch_size),
            rng=rng, shuffle=False)
    return generate_and_refine(
        cfg, model, track.diffusion.build(device), smpl, batches, ocfg,
        out_dir=args.out_dir, limit=args.limit,
        generator=torch.Generator(device=device).manual_seed(args.seed),
        extra={"respacing": args.respacing})


if __name__ == "__main__":
    main()
