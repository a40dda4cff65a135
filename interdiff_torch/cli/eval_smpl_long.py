"""SMPL-track long-term autoregressive evaluation
(`interdiff_tpu/cli/eval_smpl_long.py`), which completes what the
reference's `interdiff/eval_smpl_long.py` left unfinished (see
`eval/smpl_long.py`): the first window and ``--rollouts`` chunks after it,
each chunk re-canonicalized on the last predicted past, and the drift of
every window from the ground truth.

Usage:
  python -m interdiff_torch.cli.eval_smpl_long --motion_path DIR \\
      --model_path <SMPLH pkl dir> [--rollouts 4] [--mode correction] \\
      [--diffusion_ckpt model.pt] [--correction_ckpt projector.pt] \\
      [--respacing 100] [--out_dir DIR] [--device cpu]
  python -m interdiff_torch.cli.eval_smpl_long --synthetic N ...

It runs on the CUDA device unless ``--device`` names another; without a CUDA
device and without ``--device`` it stops.  The data windows span the whole
horizon, ``past + (1 + rollouts) * future`` frames, so that every window can
be scored; the sampler conditions on the first one only.  At most three
batches are rolled out, each written to ``<out_dir>/rollout_<i>.npy``, and
the per-window means to ``<out_dir>/drift_metrics.json``.  The checkpoints
are state dicts (`utils/convert.py::save_state_dict`); without them the
weights are the modules' seeded initial ones.  Rendering (``--render_dir``,
``--obj_mesh``) is not ported yet and stops with an error.

``setup`` builds the objects from the flags, ``evaluate_long`` is the loop
itself; ``main`` is the two.
"""

from __future__ import annotations

import json
import os
import time
from argparse import ArgumentParser, Namespace
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
from interdiff_torch.eval.smpl_long import rollout
from interdiff_torch.eval.smpl_short import (
    SmplEvalConfig,
    make_sampler,
    postprocess_sample,
)
from interdiff_torch.geometry.rotations import (
    matrix_to_axis_angle,
    rotation_6d_to_matrix,
)
from interdiff_torch.models.correction import ObjProjectorSmpl
from interdiff_torch.models.mdm_smpl import MDMSmpl, smpl_gt_from_raw
from interdiff_torch.smpl.model import SmplModel, smpl_forward

WINDOW_METRICS = ("global_mpjpe", "local_mpjpe", "body_translation",
                  "obj_translation")


def make_window_metrics(cfg: SmplEvalConfig, smpl: SmplModel,
                        num_chunks: int) -> Callable:
    """``window_metrics(full, gt_long, hand_long, betas_long) -> [{metric:
    float}]``, one dict per future window: the drift of the rollout from the
    ground truth as global and local (pelvis-relative) MPJPE and the body's
    and the object's translation error, each a batch mean (the short-term
    metric family of `reference/interdiff/eval_smpl_short.py:24-81` per
    chunk).  FK of prediction and ground truth both take the ground-truth
    hand poses and betas over the horizon."""
    D = cfg.smpl_dim + 3

    def joints(x, hand, betas):
        B, Tf = x.shape[:2]
        body = x[..., :D]
        body_aa = matrix_to_axis_angle(rotation_6d_to_matrix(
            body[..., :-3].reshape(B, Tf, -1, 6))).reshape(B, Tf, -1)
        pose = torch.cat([body_aa, hand], dim=-1)
        _, jtr, _, _ = smpl_forward(
            smpl, pose.reshape(B * Tf, -1), betas.reshape(B * Tf, -1),
            body[..., -3:].reshape(B * Tf, 3))
        return jtr.reshape(B, Tf, -1, 3)

    @torch.no_grad()
    def window_metrics(full, gt_long, hand_long, betas_long
                       ) -> List[Dict[str, float]]:
        Tf = full.shape[1]
        gt_long = gt_long[:, :Tf]
        hand_long, betas_long = hand_long[:, :Tf], betas_long[:, :Tf]
        jtr = joints(full, hand_long, betas_long)
        jtr_gt = joints(gt_long, hand_long, betas_long)
        values = []
        for w in range(1 + num_chunks):
            s = cfg.past_len + w * cfg.future_len
            e = s + cfg.future_len
            j, jg = jtr[:, s:e], jtr_gt[:, s:e]
            local = j - j[:, :, 0:1]
            local_gt = jg - jg[:, :, 0:1]
            values += [
                torch.linalg.norm(j - jg, dim=-1).mean(),
                torch.linalg.norm(local - local_gt, dim=-1).mean(),
                torch.linalg.norm(full[:, s:e, D - 3:D]
                                  - gt_long[:, s:e, D - 3:D], dim=-1).mean(),
                torch.linalg.norm(full[:, s:e, -3:] - gt_long[:, s:e, -3:],
                                  dim=-1).mean()]
        flat = torch.stack(values).tolist()  # one read of the device
        n = len(WINDOW_METRICS)
        return [dict(zip(WINDOW_METRICS, flat[i:i + n]))
                for i in range(0, len(flat), n)]

    return window_metrics


def evaluate_long(cfg: SmplEvalConfig, model: MDMSmpl,
                  diffusion: GaussianDiffusion, smpl: SmplModel,
                  batches: Iterable[Dict[str, np.ndarray]], *,
                  projector: Optional[ObjProjectorSmpl] = None,
                  rollouts: int = 4,
                  generator: Optional[torch.Generator] = None,
                  out_dir: str, max_batches: int = 3,
                  timings: Optional[Dict[str, float]] = None,
                  outputs: Optional[List[torch.Tensor]] = None
                  ) -> List[Dict[str, float]]:
    """The rollout loop (`interdiff_tpu/cli/eval_smpl_long.py:236-277`) on
    the model's device; returns the per-window means over the batches, also
    written to ``<out_dir>/drift_metrics.json``.

    Per batch (``body_pose`` [B,H,156], ``body_trans``, ``obj_angles``,
    ``obj_trans`` [B,H,3], ``obj_points`` [B,P,>=6], ``body_betas``
    [B,H,10]; H the whole horizon): the sampler (with the correction in the
    loop when ``projector`` is given; one encode per chunk) on the first
    window, ``rollouts`` chunks after it (`eval/smpl_long.py::rollout`,
    the noise from ``generator``), `make_window_metrics`, and
    ``rollout_<i>.npy``.  Stops after ``max_batches`` batches.  ``timings``
    collects the wall seconds of ``rollout`` and ``metrics`` (a device
    synchronisation around each) and the count of ``chunks``; ``outputs``
    receives each trajectory."""
    device = next(model.parameters()).device
    # the stand-in bodies may have fewer vertices than the marker set's
    # largest index; the JAX package's gather clamps such indices
    markers_idx = np.minimum(MARKERSET_SSM67_SMPLH, smpl.num_verts - 1)
    sample = make_sampler(cfg, model, diffusion, smpl=smpl,
                          projector=projector,
                          use_correction=projector is not None,
                          markers_idx=markers_idx)

    def sample_fn(gen, gt, obj_points6, hand, betas):
        return sample(gt, obj_points6, hand, betas, generator=gen)

    def pelvis_fn(x, hand, betas):
        return postprocess_sample(cfg, smpl, x, hand, betas)["pelvis"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    window_metrics = make_window_metrics(cfg, smpl, rollouts)
    totals: List[Dict[str, float]] = [dict() for _ in range(1 + rollouts)]
    os.makedirs(out_dir, exist_ok=True)
    T = cfg.seq_len
    n_batches = 0
    for i, batch in enumerate(batches):
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()
             if k in ("body_pose", "body_trans", "obj_angles", "obj_trans",
                      "obj_points", "body_betas")}
        gt_long = smpl_gt_from_raw(b["body_pose"][..., :66],
                                   b["body_trans"], b["obj_angles"],
                                   b["obj_trans"])
        obj_points6 = b["obj_points"][..., :6]
        hand_long = b["body_pose"][..., 66:]
        betas_long = b["body_betas"]
        sync()
        t0 = time.perf_counter()
        # the sampler conditions on the first window only
        full = rollout(sample_fn, pelvis_fn, generator, gt_long[:, :T],
                       obj_points6, hand_long[:, :T], betas_long[:, :T],
                       num_chunks=rollouts, cfg=cfg)
        sync()
        t1 = time.perf_counter()
        per_window = window_metrics(full, gt_long, hand_long, betas_long)
        t2 = time.perf_counter()
        if timings is not None:
            timings["rollout"] = timings.get("rollout", 0.0) + t1 - t0
            timings["metrics"] = timings.get("metrics", 0.0) + t2 - t1
            timings["chunks"] = timings.get("chunks", 0) + 1 + rollouts
        n_batches += 1
        print(f"batch {i}: rolled out {full.shape[1]} frames "
              f"({1 + rollouts} windows)", flush=True)
        for w, m in enumerate(per_window):
            for k, v in m.items():
                totals[w][k] = totals[w].get(k, 0.0) + v
            s = cfg.past_len + w * cfg.future_len
            print(f"  window {w} (frames {s}-{s + cfg.future_len}):",
                  {k: round(v / n_batches, 5) for k, v in totals[w].items()},
                  flush=True)
        np.save(os.path.join(out_dir, f"rollout_{i}.npy"),
                full.cpu().numpy())
        if outputs is not None:
            outputs.append(full)
        if n_batches >= max_batches:
            break

    summary = [{k: v / max(n_batches, 1) for k, v in t.items()}
               for t in totals]
    with open(os.path.join(out_dir, "drift_metrics.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print("rollout drift summary (per window):", summary, flush=True)
    return summary


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--diffusion_ckpt", default=None,
                        help="state dict of MDMSmpl (save_state_dict)")
    parser.add_argument("--correction_ckpt", default=None,
                        help="state dict of ObjProjectorSmpl")
    parser.add_argument("--mode", default="no_correction",
                        choices=["correction", "no_correction"])
    parser.add_argument("--rollouts", type=int, default=4,
                        help="autoregressive future chunks after the first")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--past_len", type=int, default=10)
    parser.add_argument("--future_len", type=int, default=25)
    parser.add_argument("--seed", type=int, default=233)
    parser.add_argument("--respacing", default="",
                        help="timestep respacing, e.g. '100' or 'ddim50'")
    parser.add_argument("--out_dir", default="./results")
    parser.add_argument("--render_dir", default=None,
                        help="not ported yet")
    parser.add_argument("--obj_mesh", default=None, help="not ported yet")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="roll out N synthetic batches on the 128-vertex "
                             "stand-in body (no dataset, no pkl)")
    add_data_args(parser)
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def setup(args: Namespace, device) -> Dict:
    """The keyword arguments of :func:`evaluate_long` from parsed flags:
    the models on ``device``, the body, the batches of the whole horizon
    and the generator, in the JAX CLI's order of draws."""
    rng = seed_everything(args.seed)
    cfg = SmplEvalConfig(past_len=args.past_len, future_len=args.future_len)
    track = SmplTrackConfig(
        past_len=args.past_len, future_len=args.future_len,
        diffusion=DiffusionConfig(timestep_respacing=args.respacing))
    model = track.build_model(device)
    load_weights(model, args.diffusion_ckpt)
    projector = None
    if args.mode == "correction":
        projector = CorrectionConfig(
            past_len=args.past_len,
            future_len=args.future_len).build_model(device)
        load_weights(projector, args.correction_ckpt)

    horizon = args.past_len + (1 + args.rollouts) * args.future_len
    if args.synthetic:
        smpl = synthetic_smpl_body(rng, device=device)
        batches = synthetic_smpl_batches(
            rng, batch_size=args.batch_size, seq_len=horizon, num_points=512,
            steps=args.synthetic)
    else:
        smpl_models = load_smpl_models(args, device)
        smpl = smpl_models["male"]  # one body for every clip, as in JAX
        # light fields: the loop reads the pose streams and the template
        # cloud only; the windows cover the whole horizon
        ds = BehaveDataset(load_eval_sequences(args.motion_path, smpl_models),
                           past_len=args.past_len,
                           future_len=horizon - args.past_len, rng=rng,
                           fields="light")
        args.batch_size = fit_batch_size(len(ds), args.batch_size)
        batches = batch_iterator(ds, collate, batch_size=args.batch_size,
                                 rng=rng, shuffle=False)
    return dict(cfg=cfg, model=model, diffusion=track.diffusion.build(device),
                smpl=smpl, batches=batches, projector=projector,
                rollouts=args.rollouts,
                generator=torch.Generator(device=device).manual_seed(
                    args.seed),
                out_dir=args.out_dir)


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    unported = [f"--{n}" for n in ("render_dir", "obj_mesh")
                if getattr(args, n) is not None]
    if unported:
        parser.error(f"{', '.join(unported)}: rendering is not ported yet")
    if args.rollouts < 0:
        parser.error("--rollouts must be 0 or more")
    check_data_args(parser, args)
    device = resolve_device(None if args.device == "cuda" else args.device)
    evaluate_long(**setup(args, device))
    # no return value: a console-script wrapper `sys.exit(main())` would
    # turn a returned summary into exit status 1 (the summary is printed
    # and written to drift_metrics.json)


if __name__ == "__main__":
    main()
