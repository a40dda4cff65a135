"""Skeleton-track evaluation (`interdiff_tpu/cli/eval_skeleton.py`, the
reference's `interdiff/eval_skeleton.py` with correction and
`eval_skeleton_no_correction.py` without, as ``--mode``).

Usage:
  python -m interdiff_torch.cli.eval_skeleton --synthetic N \\
      [--mode correction] [--rollouts K] [--respacing 100] \\
      [--diffusion_ckpt model.pt] [--correction_ckpt projector.pt] \\
      [--device cpu]
  python -m interdiff_torch.cli.eval_skeleton --motion_path DIR ...

It runs on the CUDA device unless ``--device`` names another; without a CUDA
device and without ``--device`` it stops.  ``--motion_path`` reads the
HO-GCN sequence pickles (`data/skeleton.py`) and evaluates the seen and the
unseen test splits; ``--synthetic N`` evaluates N random batches instead.
The checkpoints are state dicts written by
`utils/convert.py::save_state_dict`, the reference's Lightning ``.ckpt``
files (the denoiser then built from the file's hyper_parameters) or the
JAX package's orbax directories (``artifacts/skeleton_params``;
`utils/orbax_read.py`); without them the weights are the modules' seeded
initial ones.  ``--config`` may name the motion path in a YAML path config
(PyYAML is imported only then).
``--render_dir`` writes a gif of the first clip of every batch, the
prediction over the ground truth (`viz/skeleton_viz.py`, matplotlib on the
host; without matplotlib the flag stops before anything is built).

``--mesh_devices N`` (N >= 1) shards each batch's rows over N ranks
(`parallel/mesh.py`: one process a card, NCCL; with ``--device cpu`` N
gloo ranks on the CPU): each rank encodes and samples its rows (the noise
drawn for the whole batch, so the samples are those of one rank), its
rollouts included, the first window's predictions are gathered in row
order and scored, and rank 0 prints what a run of one rank prints.  As in
the JAX package the batch must divide by N and N may not exceed the
devices there are; 0 (the default) runs without a mesh.

``main`` builds the objects from the flags; ``evaluate`` is the loop itself,
on any models and iterator of batches.
"""

from __future__ import annotations

import functools
import os
from argparse import ArgumentParser
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from interdiff_torch import resolve_device
from interdiff_torch.cli.common import (
    batch_iterator,
    check_mesh_devices,
    load_correction_variables,
    load_mdm,
    seed_everything,
    synthetic_skeleton_batches,
)
from interdiff_torch.config import (
    CorrectionConfig,
    DiffusionConfig,
    SkeletonTrackConfig,
)
from interdiff_torch.diffusion.gaussian import GaussianDiffusion
from interdiff_torch.eval.metrics import skeleton_metrics
from interdiff_torch.data.paths import load_paths
from interdiff_torch.eval.skeleton import (
    SkeletonEvalConfig,
    make_skeleton_sampler,
    rollout_batch,
    split_skeleton_state,
)
from interdiff_torch.models.correction import ObjProjectorSkeleton
from interdiff_torch.models.mdm_skeleton import MDMSkeleton
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
from interdiff_torch.parallel.sample_parallel import data_parallel_sample
from interdiff_torch.utils import profiling
from interdiff_torch.viz.skeleton_viz import require_matplotlib

Noises = Iterator[Tuple[torch.Tensor, Optional[torch.Tensor]]]
KEYS = ("skeleton", "obj_points", "poses", "zero_pose_obj")


def _print_running(nb: int, running: Dict[str, float]) -> None:
    print({k: round(v, 5) for k, v in running.items()}, flush=True)


def evaluate(cfg: SkeletonEvalConfig, model: MDMSkeleton,
             diffusion: GaussianDiffusion,
             batches: Iterable[Dict[str, np.ndarray]], *,
             projector: Optional[ObjProjectorSkeleton] = None,
             rollouts: int = 0,
             generator: Optional[torch.Generator] = None,
             noises: Optional[Noises] = None,
             report: Callable[[int, Dict[str, float]], None] = _print_running,
             timings: Optional[Dict[str, float]] = None,
             trace: Optional[List[Dict]] = None,
             forecasts: Optional[List[Dict[str, torch.Tensor]]] = None,
             render_dir: Optional[str] = None,
             mesh: Optional[DataMesh] = None
             ) -> Tuple[Dict[str, float], int]:
    """The evaluation loop (`interdiff_tpu/cli/eval_skeleton.py:149-197`) on
    the model's device; returns (the sum over batches of each metric, the
    number of batches).

    Per batch (``skeleton`` [B,T,21,3], ``obj_points`` [B,T,12,3],
    ``poses`` [B,T,7], ``zero_pose_obj`` [B,12,3]; numpy or tensors):
    encode once, one sampler call on that memory, `skeleton_metrics` on the
    future frames, and ``report(batches so far, running means)``.  With
    ``rollouts`` K, K more windows follow, each re-batched from the last
    one's prediction (`rollout_batch`), encoded and sampled; the metrics
    score the first window.  ``forecasts`` receives each batch's whole
    forecast: ``body``, ``obj`` and ``pose`` over the past and K + 1
    futures.

    With ``projector`` the correction runs in the loop (``trace`` gets one
    entry per firing).  The noise is drawn from ``generator`` unless
    ``noises`` yields one ``(noise, step_noise)`` pair per sampler call.
    ``timings`` collects the wall seconds of ``encode``, ``sampler`` (the
    rollouts' calls included) and ``metrics``, with a device
    synchronisation around every part (none without it), and opens a
    session of `utils/profiling.py` unless one is open: the traced mode.
    Every batch is a span ``eval.batch`` (attribute ``b``) holding the
    parts' spans ``eval.<part>``.  With
    ``render_dir`` a gif of each batch's first clip goes there,
    ``batch<n>_<mode>.gif`` (part ``render``).

    With a data ``mesh`` each rank takes its rows of every (global) batch,
    encodes, samples (under the mesh: noise drawn for the global batch) and
    rolls them out; ``noises`` yields and ``forecasts`` receives the rank's
    rows.  The first window's predictions of every rank are gathered in row
    order and scored against the whole batch; every rank returns the
    totals, rank 0 alone reports and renders.
    """
    device = next(model.parameters()).device
    sample = make_skeleton_sampler(
        cfg, model, diffusion, projector=projector, reuse_memory=True,
        trace=trace)
    if mesh is not None:  # draws for the global batch, cut to the rows
        sample = data_parallel_sample(sample, mesh)

    timed = functools.partial(profiling.timed, timings, device)
    cuda = device.type == "cuda"

    def encode_and_sample(b):
        memory, gt = timed("eval.encode", model.encode, b["skeleton"],
                           b["obj_points"], b["poses"], b["zero_pose_obj"])
        noise, step_noise = (None, None) if noises is None else next(noises)
        return timed("eval.sampler", sample, b["skeleton"], b["obj_points"],
                     b["poses"], b["zero_pose_obj"], memory, gt, noise=noise,
                     step_noise=step_noise, generator=generator)

    def rollout(x, zero_pose_obj, pred):
        full = dict(pred)
        for _ in range(rollouts):
            x = encode_and_sample(rollout_batch(x, zero_pose_obj, cfg))
            for k, v in split_skeleton_state(x, cfg).items():
                full[k] = torch.cat([full[k], v[:, cfg.past_len:]], dim=1)
        return full

    rank0 = is_rank0(mesh)
    totals: Dict[str, float] = {}
    nb = 0
    with torch.no_grad(), profiling.session(timings is not None):
        for batch in batches:
            with profiling.span("eval.batch", cuda=cuda, cpu=True,
                                b=nb):
                whole = {k: torch.as_tensor(batch[k], device=device)
                         for k in KEYS}
                b = shard_batch(whole, mesh)
                x = encode_and_sample(b)
                pred = split_skeleton_state(x, cfg)
                full = pred
                if rollouts:
                    full = rollout(x, b["zero_pose_obj"], pred)
                    if rank0:
                        print(f"rollout: {full['body'].shape[1]} frames "
                              "total", flush=True)
                if forecasts is not None:
                    forecasts.append(full)
                if mesh is not None:  # every rank's rows, in row order
                    pred = {k: all_gather_rows(v, mesh)
                            for k, v in pred.items()}
                m = timed("eval.metrics", skeleton_metrics, pred["body"],
                          whole["skeleton"], pred["obj"],
                          whole["obj_points"], pred["pose"], whole["poses"],
                          start=cfg.past_len)
                nb += 1
                # one read of the device per batch
                values = torch.stack(list(m.values())).tolist()
                for k, v in zip(m, values):
                    totals[k] = totals.get(k, 0.0) + v
                if rank0:
                    report(nb, {k: v / nb for k, v in totals.items()})
                    if render_dir is not None:
                        mode = "correction" if projector is not None \
                            else "no_correction"
                        timed("eval.render", render_clip, b, pred,
                              cfg.past_len,
                              os.path.join(render_dir,
                                           f"batch{nb}_{mode}.gif"))
                # the other ranks wait for rank 0's report and gif outside
                # the next batch's gather
                wait_for_rank0(mesh)
    return totals, nb


def render_clip(batch: Dict[str, torch.Tensor],
                pred: Dict[str, torch.Tensor], past_len: int,
                path: str) -> str:
    """A gif of the batch's first clip (`interdiff_tpu/cli/eval_skeleton.py:
    198-207`): the ground-truth skeleton and object keypoints with the
    prediction drawn over the future frames."""
    from interdiff_torch.viz.skeleton_viz import visualize_skeleton

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    host = {k: v[0].cpu().numpy() for k, v in (
        ("body", batch["skeleton"]), ("obj", batch["obj_points"]),
        ("pred", pred["body"]), ("obj_pred", pred["obj"]))}
    visualize_skeleton(host["body"], host["obj"], path, pred=host["pred"],
                       obj_pred=host["obj_pred"], past_len=past_len)
    print("rendered", path, flush=True)
    return path


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--motion_path", default=None,
                        help="directory of HO-GCN sequence pickles")
    parser.add_argument("--mode", default="correction",
                        choices=["correction", "no_correction"])
    parser.add_argument("--diffusion_ckpt", default=None,
                        help="state dict of MDMSkeleton (save_state_dict), "
                             "a reference Lightning .ckpt, or an orbax "
                             "directory of the JAX package")
    parser.add_argument("--correction_ckpt", default=None,
                        help="state dict of ObjProjectorSkeleton, a "
                             "reference Lightning .ckpt, or an orbax "
                             "directory of the JAX package")
    parser.add_argument("--config", default=None,
                        help="YAML path config (BEHAVE.yml/HOI.yml style; "
                             "needs PyYAML): its motion path")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--past_len", type=int, default=10)
    parser.add_argument("--future_len", type=int, default=10)
    parser.add_argument("--seed", type=int, default=233)
    parser.add_argument("--respacing", default="",
                        help="timestep respacing, e.g. '100'")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="evaluate N synthetic batches (no dataset)")
    parser.add_argument("--render_dir", default=None,
                        help="write a gif of sample 0 per batch here")
    parser.add_argument("--rollouts", type=int, default=0,
                        help="autoregressive future windows after the first "
                             "(the reference's get_batch re-batching, "
                             "eval_skeleton.py:71-80)")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="shard the sampling batch over N ranks, one a "
                             "device (0 = no mesh); batch_size must divide "
                             "by N")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the default; stops without a CUDA "
                             "device) or 'cpu'")
    return parser


def main(argv=None) -> Tuple[Dict[str, float], int]:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mesh_devices > 1 and args.batch_size % args.mesh_devices:
        parser.error("--batch_size must be divisible by --mesh_devices")
    if args.config:
        args.motion_path = args.motion_path or load_paths(
            args.config).motion_path
    if not args.synthetic and not args.motion_path:
        parser.error("--motion_path is required unless --synthetic is set")
    if args.render_dir:
        try:
            require_matplotlib()
        except ImportError as e:
            parser.error(f"--render_dir: {e}")
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
    cfg = SkeletonEvalConfig(past_len=args.past_len,
                             future_len=args.future_len)
    track = SkeletonTrackConfig(
        past_len=args.past_len, future_len=args.future_len,
        diffusion=DiffusionConfig(timestep_respacing=args.respacing))
    model = load_mdm(args.diffusion_ckpt, "skeleton",
                     track.build_model(device), past_len=args.past_len,
                     future_len=args.future_len)
    diffusion = track.diffusion.build(device)
    projector = None
    if args.mode == "correction":
        projector = CorrectionConfig(
            track="skeleton", num_nodes=cfg.num_joints,
            past_len=args.past_len,
            future_len=args.future_len).build_model(device)
        load_correction_variables(projector, args.correction_ckpt,
                                  "skeleton")

    def batches():
        if args.synthetic:
            yield from synthetic_skeleton_batches(
                rng, batch_size=args.batch_size, seq_len=cfg.seq_len,
                steps=args.synthetic)
            return
        from interdiff_torch.data.skeleton import (
            collate_skeleton,
            load_skeleton_datasets,
        )

        _, _, test_seen, test_unseen = load_skeleton_datasets(
            args.motion_path)
        for name, split in (("seen", test_seen), ("unseen", test_unseen)):
            if is_rank0(mesh):
                print(f"--- {name} split: {len(split)} clips ---",
                      flush=True)
            yield from batch_iterator(split, collate_skeleton,
                                      batch_size=args.batch_size, rng=rng,
                                      shuffle=False)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    return evaluate(cfg, model, diffusion, batches(), projector=projector,
                    rollouts=args.rollouts, generator=generator,
                    render_dir=args.render_dir, mesh=mesh)


if __name__ == "__main__":
    main()
