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
`utils/convert.py::save_state_dict`, the reference's Lightning ``.ckpt``
files (the denoiser then built from the file's hyper_parameters, with
exact FPS: `cli/common.py::load_mdm`) or the JAX package's orbax
directories (``artifacts/smpl_real_params``,
``artifacts/correction_real_params``; `utils/orbax_read.py`); without them
the weights are the modules' seeded initial ones.  ``--render_dir`` writes
a four-view gif of the first sample of every batch (the seam smoothed
first, as the reference does), the object as the mesh of ``--obj_mesh``
under the predicted pose, or found beside a one-category corpus
(``objects/<cat>/<cat>_f1000.ply``), else as point spheres of its template
cloud; the gif is drawn on the host.

``--mesh_devices N`` (N >= 1) shards the tiled diverse batch's rows over N
ranks (`parallel/mesh.py`: one process a card, NCCL; with ``--device cpu``
N gloo ranks on the CPU; under torchrun the processes it started): each
rank encodes, samples (the noise drawn for the whole batch and cut to its
rows, so the samples are those of one rank), post-processes and scores its
own rows, the per-sample metrics are gathered in row order, and rank 0
prints what a run of one rank prints.  As in the JAX package the batch must
divide by N, N may not exceed the devices there are, and a corpus-fitted
batch shrinks to a multiple of N.  ``--mesh_devices 0`` (the default) runs
without a mesh.

``main`` builds the objects from the flags; ``evaluate`` is the loop itself,
on any body, models and iterator of batches.
"""

from __future__ import annotations

import functools
import os
from argparse import ArgumentParser
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.cli.common import (
    add_data_args,
    batch_iterator,
    check_data_args,
    check_mesh_devices,
    check_obj_mesh,
    find_object_mesh,
    fit_batch_size,
    load_eval_sequences,
    load_smpl_models,
    load_correction_variables,
    load_mdm,
    load_object_mesh,
    render_smpl_sample,
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
from interdiff_torch.parallel.mesh import (
    DataMesh,
    all_gather_rows,
    is_rank0,
    launch,
    make_mesh,
    process_device,
    shard_batch,
    wait_for_rank0,
)
from interdiff_torch.parallel.sample_parallel import (
    best_of_n_metrics,
    data_parallel_sample,
    tile_for_diverse_samples,
)
from interdiff_torch.smpl.model import SmplModel
from interdiff_torch.utils import profiling

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
             timings: Optional[Dict[str, float]] = None,
             render_dir: Optional[str] = None,
             obj_mesh: Optional[Tuple[np.ndarray, np.ndarray]] = None,
             mesh: Optional[DataMesh] = None
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
    device synchronisation around every part (none without it), and opens
    a session of `utils/profiling.py` unless one is open: the traced mode.
    Every batch is a span ``eval.batch`` (attribute ``b``) holding the
    parts' spans ``eval.<part>``.  With
    ``render_dir``, a gif ``batch<n>.gif`` of the last sampler call's first
    row goes there after each batch (`cli/common.py::render_smpl_sample`,
    part ``render``).

    With a data ``mesh`` each rank takes its rows of the tiled batch
    [fold * B] (``batches`` holds the global batches on every rank): it
    encodes them, runs FK on their gt, samples them under the mesh (noise
    drawn for the global batch), scores them, and the per-sample metrics
    of every rank are gathered in row order before the best-of-N minimum;
    ``noises`` then yields the rank's rows.  Every rank returns the totals;
    rank 0 alone reports and renders.
    """
    if diverse_fold < 1 or diverse_samples % diverse_fold:
        raise ValueError("diverse_fold must be positive and divide "
                         "diverse_samples")
    device = next(model.parameters()).device
    sample = make_sampler(
        cfg, model, diffusion, smpl=smpl, projector=projector,
        markers_idx=markers_idx, reuse_memory=True, sampler=sampler)
    if mesh is not None:  # draws for the global batch, cut to the rows
        sample = data_parallel_sample(sample, mesh)
    p = cfg.past_len

    timed = functools.partial(profiling.timed, timings, device)
    cuda = device.type == "cuda"

    def metrics(out, gt_post, obj_pts3):
        return smpl_metrics(
            out["obj_pred"][:, p:], out["jtr"][:, p:],
            out["body_pred"][:, p:], gt_post["obj_pred"][:, p:],
            gt_post["jtr"][:, p:], gt_post["body_pred"][:, p:],
            out["verts"][:, p:], smpl.faces_idx, obj_pts3,
            nn_prune_delta=metrics_prune_delta, incident=smpl.incident)

    def gathered(m: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if mesh is None:
            return m
        rows = all_gather_rows(torch.stack(list(m.values()), dim=1), mesh)
        return dict(zip(m, rows.unbind(1)))

    rank0 = is_rank0(mesh)
    keys = ("body_pose", "body_trans", "obj_angles", "obj_trans",
            "obj_points", "body_betas")
    totals: Dict[str, float] = {}
    nb = 0
    with torch.no_grad(), profiling.session(timings is not None):
        for batch in batches:
            with profiling.span("eval.batch", cuda=cuda, cpu=True,
                                b=nb):
                if mesh is None:
                    b = {k: torch.as_tensor(v, device=device)
                         for k, v in batch.items() if k in keys}
                else:
                    # this rank's rows of the tiled batch: sample i of clip
                    # c at row i * B + c
                    b = {k: shard_batch(tile_for_diverse_samples(
                        torch.as_tensor(v), diverse_fold), mesh).to(device)
                        for k, v in batch.items() if k in keys}
                gt = smpl_gt_from_raw(b["body_pose"][..., :66],
                                      b["body_trans"], b["obj_angles"],
                                      b["obj_trans"])
                obj_points6 = b["obj_points"][..., :6]
                hand = b["body_pose"][..., 66:]
                betas = b["body_betas"] if "body_betas" in b \
                    else gt.new_zeros(gt.shape[:2] + (10,))

                memory = timed("eval.encode", model.encode, gt, obj_points6)
                # ground-truth FK once on the untiled batch: it is
                # deterministic
                gt_post = timed("eval.postprocess", postprocess_sample, cfg,
                                smpl, gt, hand, betas)
                if diverse_fold > 1 and mesh is None:
                    gt, obj_points6, hand, betas, memory = \
                        tile_for_diverse_samples(
                            (gt, obj_points6, hand, betas, memory),
                            diverse_fold)
                    gt_post = {k: tile_for_diverse_samples(v, diverse_fold)
                               for k, v in gt_post.items()}
                best = None
                for _ in range(diverse_samples // diverse_fold):
                    noise, step_noise = (None, None) if noises is None \
                        else next(noises)
                    x = timed("eval.sampler", sample, gt, obj_points6, hand,
                              betas, memory, noise=noise,
                              step_noise=step_noise, generator=generator)
                    out = timed("eval.postprocess", postprocess_sample, cfg,
                                smpl, x, hand, betas)
                    m = timed("eval.metrics", metrics, out, gt_post,
                              obj_points6[..., :3])
                    m = best_of_n_metrics(gathered(m), diverse_fold)
                    best = m if best is None else {
                        k: torch.minimum(best[k], m[k]) for k in m}
                nb += 1
                # one read of the device per batch
                means = torch.stack([v.mean() for v in best.values()]
                                    ).tolist()
                for k, v in zip(best, means):
                    totals[k] = totals.get(k, 0.0) + v
                if rank0:
                    report(nb, {k: v / nb for k, v in totals.items()})
                    if render_dir is not None:
                        timed("eval.render", render_smpl_sample, cfg, smpl,
                              out, b["obj_points"][0, :, :3].cpu().numpy(),
                              obj_mesh,
                              os.path.join(render_dir, f"batch{nb}.gif"))
                # the other ranks wait for rank 0's report and gif outside
                # the next batch's gather
                wait_for_rank0(mesh)
    return totals, nb


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--diffusion_ckpt", default=None,
                        help="state dict of MDMSmpl (save_state_dict), a "
                             "reference Lightning .ckpt, or an orbax "
                             "directory of the JAX package")
    parser.add_argument("--correction_ckpt", default=None,
                        help="state dict of ObjProjectorSmpl, a reference "
                             "Lightning .ckpt, or an orbax directory of the "
                             "JAX package")
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
                        choices=list(GaussianDiffusion.SAMPLERS))
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
    parser.add_argument("--render_dir", default=None,
                        help="write a gif of sample 0 per batch "
                             "(seam-smoothed) here")
    parser.add_argument("--obj_mesh", default=None,
                        help="simplified object mesh (ply/obj) rendered "
                             "under the predicted pose; found beside "
                             "--motion_path when omitted (one category)")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="shard the sampling, FK and metrics batch over "
                             "N ranks, one a device (0 = no mesh); "
                             "batch_size must divide by N")
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
    if args.mesh_devices > 1 and args.batch_size % args.mesh_devices:
        parser.error("--batch_size must be divisible by --mesh_devices "
                     "(each rank takes an equal share of the batch)")
    check_obj_mesh(parser, args.obj_mesh)
    check_data_args(parser, args)
    device = resolve_device(None if args.device == "cuda" else args.device)
    check_mesh_devices(parser, args, device)
    if args.mesh_devices < 1:
        return run(args, device)
    # rank 0's result (every rank's totals are the same)
    return launch(run, args.mesh_devices, args=(args, device),
                  device=device)[0]


def run(args, device) -> Tuple[Dict[str, float], int]:
    """One rank of :func:`main` (the whole run without a mesh)."""
    device = process_device(device)
    mesh = make_mesh(data=args.mesh_devices, device=device) \
        if args.mesh_devices >= 1 else None
    if args.mesh_devices >= 1 and mesh is None:
        return {}, 0  # a rank of the process group beyond --mesh_devices
    rng = seed_everything(args.seed)
    cfg = SmplEvalConfig(
        past_len=args.past_len, future_len=args.future_len,
        nn_prune_delta=args.nn_prune_delta if args.nn_prune_delta > 0
        else None)
    track = SmplTrackConfig(
        past_len=args.past_len, future_len=args.future_len,
        diffusion=DiffusionConfig(timestep_respacing=args.respacing))
    model = load_mdm(args.diffusion_ckpt, "smpl", track.build_model(device),
                     past_len=args.past_len, future_len=args.future_len)
    diffusion = track.diffusion.build(device)

    projector = None
    if args.mode == "correction":
        projector = CorrectionConfig(
            past_len=args.past_len,
            future_len=args.future_len).build_model(device)
        load_correction_variables(projector, args.correction_ckpt)

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
        seqs = load_eval_sequences(args.motion_path, smpl_models)
        # a mesh found on disk only for a one-category corpus: with mixed
        # objects the right mesh is per clip (point spheres then)
        if args.render_dir and not args.obj_mesh and len(
                {s.obj_name for s in seqs}) == 1:
            args.obj_mesh = find_object_mesh(args.motion_path,
                                             seqs[0].obj_name)
        # light fields: the loop reads the pose streams and the template
        # cloud only (contacts are recomputed in the loop)
        ds = BehaveDataset(seqs, past_len=args.past_len,
                           future_len=args.future_len, rng=rng,
                           fields="light")
        batch_size = fit_batch_size(len(ds), args.batch_size)
        if mesh is not None and batch_size % mesh.size:
            # keep the shrunk batch shardable over the ranks
            batch_size -= batch_size % mesh.size
            if batch_size == 0:
                raise SystemExit(f"corpus too small to shard over "
                                 f"{mesh.size} devices")
            if is_rank0(mesh):
                print(f"shrinking batch to {batch_size} (divisible by "
                      f"--mesh_devices)", flush=True)
        batches = batch_iterator(ds, collate, batch_size=batch_size,
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
        markers_idx=markers_idx, generator=generator,
        render_dir=args.render_dir,
        obj_mesh=load_object_mesh(args.obj_mesh) if args.obj_mesh else None,
        mesh=mesh)


if __name__ == "__main__":
    main()
