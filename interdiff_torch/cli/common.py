"""Shared set-up of the entry points (`interdiff_tpu/cli/common.py`):
seeding, the `--synthetic` batches of both tracks and the stand-in body, the
host-side batch iterator and stacker, the loader of the port's own weight
files, the loop of the two correction trainers, and the data route of the
SMPL entry points: the flags ``--motion_path``, ``--model_path``,
``--config`` and ``--synthetic_body``, the SMPL-H bodies and the BEHAVE
splits.  The readers of orbax
directories and of the reference's Lightning checkpoints are not ported: a
checkpoint comes across once, through `utils/convert.py`, and is kept as a
`torch.save`d state dict.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser, Namespace
from typing import (
    Callable,
    Dict,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from interdiff_torch.data.behave import BehaveSequence, load_behave_sequences
from interdiff_torch.data.paths import load_paths
from interdiff_torch.smpl.loader import smpl_model_from_pkl
from interdiff_torch.smpl.model import SmplModel
from interdiff_torch.utils.convert import load_state_dict
from interdiff_torch.utils.train_io import CheckpointManager, MetricsLogger


def seed_everything(seed: int = 233) -> np.random.Generator:
    """Seed numpy's and torch's global generators and return the numpy
    `Generator` that the synthetic data is drawn from."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return np.random.default_rng(seed)


def synthetic_smpl_batches(rng: np.random.Generator, *, batch_size: int,
                           seq_len: int, num_points: int = 512,
                           num_verts: int = 64, steps: int = 4
                           ) -> Iterator[Dict[str, np.ndarray]]:
    """Random BEHAVE-shaped batches, the same draws in the same order as
    `interdiff_tpu/cli/common.py::synthetic_smpl_batches`, so that one seed
    gives one batch on both sides."""
    B, T = batch_size, seq_len
    for _ in range(steps):
        yield {
            "body_pose": rng.standard_normal((B, T, 156)).astype(np.float32) * 0.2,
            "body_betas": rng.standard_normal((B, T, 10)).astype(np.float32),
            "body_trans": rng.standard_normal((B, T, 3)).astype(np.float32),
            "obj_angles": rng.standard_normal((B, T, 3)).astype(np.float32),
            "obj_trans": rng.standard_normal((B, T, 3)).astype(np.float32),
            "markers": rng.standard_normal((B, T, 67, 7)).astype(np.float32),
            "human_verts": rng.standard_normal(
                (B, T, num_verts, 7)).astype(np.float32),
            "obj_points": rng.standard_normal(
                (B, num_points, 6)).astype(np.float32),
            "obj_points_frames": rng.standard_normal(
                (B, T, num_points, 7)).astype(np.float32),
            "ground_joint_label": np.zeros((B, T, 2), np.float32),
            "gender": np.zeros((B,), np.int32),
        }


def synthetic_skeleton_batches(rng: np.random.Generator, *, batch_size: int,
                               seq_len: int, steps: int = 4
                               ) -> Iterator[Dict[str, np.ndarray]]:
    """Random HO-GCN-shaped batches (`collate_skeleton` layout), the same
    draws in the same order as
    `interdiff_tpu/cli/common.py::synthetic_skeleton_batches`."""
    B, T = batch_size, seq_len
    for _ in range(steps):
        quat = rng.standard_normal((B, T, 4)).astype(np.float32)
        quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
        poses = np.concatenate(
            [rng.standard_normal((B, T, 3)).astype(np.float32), quat], axis=-1)
        yield {
            "skeleton": rng.standard_normal((B, T, 21, 3)).astype(np.float32),
            "obj_points": rng.standard_normal((B, T, 12, 3)).astype(np.float32),
            "poses": poses,
            "zero_pose_obj": rng.standard_normal((B, 12, 3)).astype(np.float32),
        }


def batch_iterator(dataset, collate_fn, *, batch_size: int,
                   rng: np.random.Generator, shuffle: bool = True,
                   drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Host-side minibatches of ``dataset`` (the JAX package's replacement
    of the torch DataLoader): the order shuffled by ``rng`` when asked, a
    short last batch dropped unless ``drop_last`` is False."""
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for s in range(0, len(order) - (batch_size - 1 if drop_last else 0),
                   batch_size):
        idx = order[s : s + batch_size]
        if len(idx) < batch_size and drop_last:
            break
        yield collate_fn([dataset[int(i)] for i in idx])


def stack_batches(batches: Iterable[Dict[str, np.ndarray]], spd: int,
                  device, keys: Sequence[str]
                  ) -> Iterator[Tuple[Dict[str, np.ndarray],
                                      Dict[str, torch.Tensor]]]:
    """(last raw batch, its ``keys`` as tensors on ``device``) per dispatch
    of a trainer: one batch, or ``spd`` batches stacked on a new leading
    axis (`train/trainer.py::chain_steps`).  A trailing partial stack is
    dropped with a warning; with no full stack at all the run stops."""
    buf, yielded = [], 0
    for b in batches:
        buf.append(b)
        if len(buf) < spd:
            continue
        if spd == 1:
            placed = {k: torch.as_tensor(buf[0][k], device=device)
                      for k in keys}
        else:
            placed = {k: torch.as_tensor(np.stack([x[k] for x in buf]),
                                         device=device) for k in keys}
        yield buf[-1], placed
        yielded += 1
        buf = []
    if buf:
        msg = (f"steps_per_dispatch={spd}: dropped trailing partial stack "
               f"of {len(buf)} batch(es)")
        if yielded == 0:
            raise SystemExit(
                f"ERROR: {msg} and the epoch yielded NO full stack: 0 train "
                f"steps. Lower --steps_per_dispatch or raise the "
                f"dataset/--synthetic size.")
        print(f"WARNING: {msg}", flush=True)


def fit_batch_size(num_clips: int, batch_size: int) -> int:
    """Shrink the batch to the corpus so that drop-last batching cannot
    yield zero batches on a small corpus."""
    if 0 < num_clips < batch_size:
        print(f"only {num_clips} clip windows; shrinking batch "
              f"{batch_size} -> {num_clips}")
        return num_clips
    return batch_size


def load_weights(module: torch.nn.Module, path: Optional[str]) -> None:
    """Load a `utils/convert.py::save_state_dict` file into ``module``, every
    key matched; without a path the module keeps its initial weights."""
    if path:
        device = next(module.parameters()).device
        module.load_state_dict(load_state_dict(path, device), strict=True)


def correction_train_loop(
    projector: torch.nn.Module, state, step_for_epoch: Callable[[int],
                                                                Callable],
    epoch_batches: Callable[[], Iterable[Dict[str, np.ndarray]]],
    keys: Sequence[str], *, results_dir: str, epochs: int, ckpt_every: int,
    generator: Optional[torch.Generator] = None,
    on_step: Optional[Callable] = None, log: Optional[Sequence[str]] = None
) -> Tuple[object, Dict]:
    """The loop of the correction trainers
    (`interdiff_tpu/cli/train_correction_{smpl,skeleton}.py`): per epoch the
    step ``step_for_epoch(epoch)`` over ``epoch_batches()`` (their ``keys``
    placed on the projector's device), ``step(state, batch, generator,
    epoch)``; every 10th step logs the metrics named in ``log`` (all of
    them when None) and prints the loss; every ``ckpt_every`` epochs and after the last one the
    projector's state dict (parameters and BatchNorm statistics) goes to
    ``<results_dir>/ckpt/`` with the step's loss.  ``on_step(steps so far,
    state, metrics)`` runs after every step, the metrics on the device.
    Returns (state, {"steps", "loss": the last step's})."""
    device = next(projector.parameters()).device
    ckpt = CheckpointManager(os.path.join(results_dir, "ckpt"))
    logger = MetricsLogger(os.path.join(results_dir, "metrics.jsonl"))
    i, metrics = 0, None
    for epoch in range(epochs):
        step = step_for_epoch(epoch)
        for batch in epoch_batches():
            placed = {k: torch.as_tensor(batch[k], device=device)
                      for k in keys}
            state, metrics = step(state, placed, generator, float(epoch))
            if i % 10 == 0:
                logger.log(i, {k: metrics[k] for k in (log or metrics)},
                           epoch=epoch)
                print(f"step {i} loss {float(metrics['loss']):.4f}",
                      flush=True)
            i += 1
            if on_step is not None:
                on_step(i, state, metrics)
        if metrics is not None and ((epoch + 1) % ckpt_every == 0
                                    or epoch + 1 == epochs):
            ckpt.save(i, projector.state_dict(),
                      val_loss=float(metrics["loss"]))
    ckpt.wait()
    logger.close()
    print("done:", i, "steps", flush=True)
    return state, {"steps": i, "loss": None if metrics is None
                   else float(metrics["loss"])}


def synthetic_smpl_body(rng: np.random.Generator, *, num_verts: int = 128,
                        num_joints: int = 52, device=None) -> SmplModel:
    """SMPL-H-shaped stand-in body (real pkls are not shipped): the same
    array shapes and kinematic-tree depth, and the same arrays from the same
    ``rng`` as `interdiff_tpu/cli/common.py::synthetic_smpl_body`.

    The template is a closed watertight surface (a Fibonacci-sphere
    ellipsoid triangulated by its convex hull, 2V-4 faces: V=6890 gives the
    real SMPL-H's 13776) with spatially smooth skinning weights (softmax
    over per-joint surface anchors), so that skinned vertices stay a
    coherent surface and signed distances behave as on a real body.
    """
    from scipy.spatial import ConvexHull

    V, J = num_verts, num_joints
    parents = np.zeros(J, dtype=np.int64)
    for j in range(1, J):
        parents[j] = (j - 1) // 2

    # Fibonacci sphere -> human-proportioned ellipsoid with smooth bumps
    i = np.arange(V, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0)) * i
    y = 1.0 - 2.0 * (i + 0.5) / V
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    unit = np.stack([r * np.cos(phi), y, r * np.sin(phi)], axis=1)
    hull = ConvexHull(unit)
    faces = hull.simplices.astype(np.int32)
    # orient every triangle outward (hull simplices are unordered)
    tri = unit[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("fi,fi->f", n, tri.mean(axis=1)) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    bump = 1.0 + 0.08 * np.sin(3.0 * phi + rng.random() * 6.28) \
        * np.cos(2.0 * np.arccos(np.clip(y, -1, 1)))
    v_template = (unit * bump[:, None]
                  * np.array([0.25, 0.85, 0.15])).astype(np.float64)

    # smooth weights: joints anchored on the surface, soft nearest-anchor
    anchors = v_template[rng.choice(V, size=J, replace=V < J)]
    d2 = ((v_template[:, None] - anchors[None]) ** 2).sum(-1)
    w = np.exp(-d2 / 0.02)
    w /= w.sum(1, keepdims=True)
    jr = np.exp(-d2.T / 0.005)
    jr /= jr.sum(1, keepdims=True)

    return SmplModel.create(
        v_template=v_template,
        shapedirs=rng.standard_normal((V, 3, 10)) * 0.01,
        posedirs=rng.standard_normal((V, 3, 9 * (J - 1))) * 0.001,
        j_regressor=jr, weights=w, parents=parents, faces=faces,
        device=device)


def add_data_args(parser: ArgumentParser) -> None:
    """The data-route flags of the SMPL entry points."""
    parser.add_argument("--motion_path", default=None,
                        help="folder of BEHAVE sequences (<name>/"
                             "{smpl_fit_all,object_fit_all,contact}.npz, "
                             "info.json); Date03* sequences are the test "
                             "split")
    parser.add_argument("--model_path", default=None,
                        help="folder of SMPLH_{male,female}.pkl")
    parser.add_argument("--config", default=None,
                        help="YAML path config (BEHAVE.yml/HOI.yml style; "
                             "needs PyYAML)")
    parser.add_argument("--synthetic_body", action="store_true",
                        help="the sequences of --motion_path on the "
                             "6890-vertex stand-in body instead of the "
                             "SMPL-H pkls")


def check_data_args(parser: ArgumentParser, args: Namespace) -> None:
    """Choose the data route: ``--synthetic N`` alone, or ``--motion_path``
    with ``--model_path`` or ``--synthetic_body`` (either path may come
    from ``--config``); stops through ``parser.error`` otherwise."""
    dataset = [f"--{n}" for n in ("motion_path", "model_path", "config")
               if getattr(args, n)]
    dataset += ["--synthetic_body"] if args.synthetic_body else []
    if args.synthetic and dataset:
        parser.error(f"--synthetic N and {', '.join(dataset)} are two data "
                     "routes: give one")
    if args.config:
        paths = load_paths(args.config)
        args.motion_path = args.motion_path or paths.motion_path
        args.model_path = args.model_path or paths.model_path
    if not args.synthetic and not (
            args.motion_path and (args.model_path or args.synthetic_body)):
        parser.error("--motion_path and --model_path are required (or "
                     "--synthetic N, or --motion_path with "
                     "--synthetic_body)")


def load_smpl_models(args: Namespace, device) -> Dict[str, SmplModel]:
    """The bodies of the dataset route, by gender, on ``device``: the
    SMPLH_{male,female}.pkl of ``--model_path``, or with
    ``--synthetic_body`` the 6890-vertex stand-in body from seed 0 for
    both (`interdiff_tpu/cli/common.py::load_smpl_models`)."""
    if args.synthetic_body:
        body = synthetic_smpl_body(np.random.default_rng(0), num_verts=6890,
                                   device=device)
        return {"male": body, "female": body}
    return {g: smpl_model_from_pkl(
        os.path.join(args.model_path, f"SMPLH_{g}.pkl"), device=device)
        for g in ("male", "female")}


def load_eval_sequences(motion_path: str,
                        smpl_models: Dict[str, SmplModel],
                        mode: str = "test",
                        timings: Optional[Dict[str, float]] = None
                        ) -> List[BehaveSequence]:
    """The ``mode`` split of ``motion_path``, falling back to the train
    split when a partial corpus has no Date03* sequence; the forward runs on
    the bodies' device."""
    seqs = load_behave_sequences(motion_path, smpl_models=smpl_models,
                                 mode=mode, timings=timings)
    if not seqs and mode == "test":
        print("no Date03* test sequences under", motion_path,
              "- falling back to the train split", flush=True)
        seqs = load_behave_sequences(motion_path, smpl_models=smpl_models,
                                     mode="train", timings=timings)
    return seqs
