"""Shared set-up of the entry points (`interdiff_tpu/cli/common.py`):
seeding, the `--synthetic` batches of both tracks and the stand-in body, the
host-side batch iterator and stacker, the loaders of weights (the port's
own state-dict files and the reference's Lightning ``.ckpt`` files), the
trainers' profiler flags, the loop of the two correction trainers, and the
data route of the SMPL entry points: the flags ``--motion_path``,
``--model_path``, ``--config`` and ``--synthetic_body``, the SMPL-H bodies
and the BEHAVE splits.  Every checkpoint flag also takes an orbax directory
of the JAX package (a flat save such as ``artifacts/smpl_real_params`` or a
trainer's ``CheckpointManager`` directory), read without JAX by
`utils/orbax_read.py`; `scripts/torch_convert_orbax.py` is the tests'
oracle of that route through JAX and orbax.
"""

from __future__ import annotations

import contextlib
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
from interdiff_torch.parallel.mesh import (
    DataMesh,
    is_rank0,
    launch,
    local_devices,
    wait_for_rank0,
)
from interdiff_torch.smpl.loader import smpl_model_from_pkl
from interdiff_torch.smpl.model import SmplModel
from interdiff_torch.utils.checkpoint import (
    converted_hparams,
    correction_state_dict,
    mdm_skeleton_from_checkpoint,
    mdm_skeleton_from_hparams,
    mdm_smpl_from_checkpoint,
    mdm_smpl_from_hparams,
)
from interdiff_torch.utils import orbax_read
from interdiff_torch.utils.convert import (
    flax_to_torch_state_dict,
    load_state_dict,
)
from interdiff_torch.utils.prefetch import place_batch
from interdiff_torch.utils.profiling import (
    StepTimer,
    enable_anomaly_detection,
    trace,
)
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
                  device, keys: Sequence[str],
                  section: Callable[[str], contextlib.AbstractContextManager]
                  = lambda name: contextlib.nullcontext(),
                  place: Optional[Callable] = None
                  ) -> Iterator[Tuple[Dict[str, np.ndarray],
                                      Dict[str, torch.Tensor]]]:
    """(last raw batch, its ``keys`` as tensors on ``device``) per dispatch
    of a trainer: one batch, or ``spd`` batches stacked on a new leading
    axis (`train/trainer.py::chain_steps`), placed by
    `utils/prefetch.py::place_batch` (or by ``place(stacked)``, a
    data-parallel step's rows of it) inside ``section("batch_place")``.  A
    trailing partial stack is dropped with a warning; with no full stack at
    all the run stops."""
    buf, yielded = [], 0
    for b in batches:
        buf.append(b)
        if len(buf) < spd:
            continue
        with section("batch_place"):
            stacked = buf[0] if spd == 1 else {
                k: np.stack([x[k] for x in buf]) for k in keys}
            placed = place_batch(stacked, device, keys) if place is None \
                else place(stacked)
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


def check_mesh_devices(parser: ArgumentParser, args: Namespace,
                       device) -> None:
    """The JAX evals' check of ``--mesh_devices`` once the device is known:
    N is at most the devices there are (CUDA devices, or the CPU's cores
    for gloo ranks)."""
    available = local_devices(device)
    if args.mesh_devices > available:
        parser.error(f"--mesh_devices {args.mesh_devices} > {available} "
                     "available devices")


def _summary_of(run: Callable, args: Namespace, device) -> Dict:
    return run(args, device)[1]


def launch_trainer(run: Callable, args: Namespace, device) -> Tuple:
    """Run a trainer's ``run(args, device) -> (state, summary)`` as the JAX
    trainers run over every local device: one rank a visible card (one
    rank on the CPU), each building its mesh with `parallel/mesh.py::
    make_mesh(batch_size=...)`; under torchrun, as this process's rank.
    Spawned ranks keep their states: then (None, rank 0's summary)."""
    device = torch.device(device)
    world = local_devices(device) if device.type == "cuda" else 1
    if "WORLD_SIZE" in os.environ or world == 1:
        return launch(run, world, args=(args, device), device=device)[0]
    return None, launch(_summary_of, world, args=(run, args, device),
                        device=device)[0]


def snapshot_sources(results_dir: str, modules: Sequence[str]) -> None:
    """Copy the given source modules into ``<results_dir>/src_snapshot``
    (`interdiff_tpu/cli/common.py::snapshot_sources`, the reference's
    ``on_train_start`` source snapshot); a module that does not import is
    left out."""
    import importlib
    import shutil

    dst = os.path.join(results_dir, "src_snapshot")
    os.makedirs(dst, exist_ok=True)
    for name in modules:
        try:
            path = importlib.import_module(name).__file__
            shutil.copy(path, os.path.join(dst, os.path.basename(path)))
        except Exception:  # noqa: BLE001 - a snapshot never stops a run
            pass


def _is_lightning(path: Optional[str]) -> bool:
    return bool(path) and path.endswith(".ckpt") and os.path.isfile(path)


def load_weights(module: torch.nn.Module, path: Optional[str]) -> None:
    """Load weights into ``module``, every key matched and every shape
    checked (a mismatch raises and names the key): from a
    `utils/convert.py::save_state_dict` file, or from a directory, which
    must be an orbax save of the JAX package (`utils/orbax_read.py::
    restore`, then `flax_to_torch_state_dict`, as JAX restores into the
    CLI's module); without a path the module keeps its initial weights."""
    if path:
        device = next(module.parameters()).device
        if os.path.isdir(path):
            state = {k: v.to(device) for k, v in flax_to_torch_state_dict(
                orbax_read.restore(path)).items()}
        else:
            state = load_state_dict(path, device)
        module.load_state_dict(state, strict=True)


def load_mdm(diffusion_ckpt: Optional[str], track: str,
             model: torch.nn.Module, *, past_len: int, future_len: int
             ) -> torch.nn.Module:
    """One load path for every eval entry point's ``--diffusion_ckpt``
    (`interdiff_tpu/cli/common.py::load_mdm`): a reference Lightning
    ``.ckpt`` file replaces ``model`` by the module its hyper_parameters
    describe (`utils/checkpoint.py::mdm_{smpl,skeleton}_from_checkpoint`, on
    ``model``'s device), and so does a state-dict file that
    `cli/convert_checkpoint.py` wrote with its ``hparams.json`` beside it
    (the same module, exact FPS included, then the state dict); any other
    state-dict file of the port, and an orbax directory of the JAX package,
    is loaded into ``model`` (`load_weights`); without a path ``model``
    keeps its weights.  Returns the module to run.

    The rebuilt routes check the embedded window sizes against
    ``past_len``/``future_len``: the data windows and inpainting masks are
    built from the flags, and a silent mismatch would run to completion with
    meaningless metrics."""
    device = next(model.parameters()).device
    if _is_lightning(diffusion_ckpt):
        loader = (mdm_smpl_from_checkpoint if track == "smpl"
                  else mdm_skeleton_from_checkpoint)
        model, hp = loader(diffusion_ckpt, device)
    else:
        hp = converted_hparams(diffusion_ckpt)
        if hp is None:
            load_weights(model, diffusion_ckpt)
            return model
        if hp["kind"] != f"mdm_{track}":
            raise ValueError(
                f"--diffusion_ckpt {diffusion_ckpt} was converted from a "
                f"{hp['kind']} checkpoint; the {track} track needs mdm_{track}")
        model = (mdm_smpl_from_hparams(hp, use_pointnet2=hp["use_pointnet2"],
                                       device=device) if track == "smpl"
                 else mdm_skeleton_from_hparams(hp, device))
        load_weights(model, diffusion_ckpt)
    # MDMSkeleton has no future_len: the embedded hyper_parameters decide
    ckpt_future = int(hp.get("future_len",
                             getattr(model, "future_len", future_len)))
    if model.past_len != past_len or ckpt_future != future_len:
        raise ValueError(
            f"--diffusion_ckpt {diffusion_ckpt} embeds past_len="
            f"{model.past_len}, future_len={ckpt_future}, but the CLI runs "
            f"with --past_len {past_len} --future_len {future_len}; pass "
            "matching window flags (dataset windows and inpaint masks are "
            "built from them)")
    return model


def load_correction_variables(projector: torch.nn.Module,
                              path: Optional[str], kind: str = "smpl"
                              ) -> None:
    """Load ``--correction_ckpt`` into ``projector``
    (`interdiff_tpu/cli/common.py::load_correction_variables`): a reference
    Lightning ``.ckpt`` file through `utils/checkpoint.py` (``kind`` 'smpl'
    or 'skeleton'), a state-dict file of the port or an orbax directory of
    the JAX package (`load_weights`); without a path the projector keeps
    its weights."""
    if not _is_lightning(path):
        load_weights(projector, path)
        return
    device = next(projector.parameters()).device
    projector.load_state_dict(
        {k: v.to(device) for k, v in correction_state_dict(
            path, kind).items()}, strict=True)


def add_profiler_args(parser: ArgumentParser) -> None:
    """``--profiler`` and ``--debug_nan`` of every trainer (the reference's
    Simple/AdvancedProfiler flag, `train_diffusion_smpl.py:585,641`, and its
    always-on `set_detect_anomaly`, `:608`, here opt-in)."""
    parser.add_argument("--profiler", default=None,
                        choices=["simple", "trace"],
                        help="'simple' = per-section wall-clock summary; "
                             "'trace' = torch.profiler trace (CPU and CUDA) "
                             "into <results_dir>/trace")
    parser.add_argument("--debug_nan", action="store_true",
                        help="torch anomaly detection with NaN checks (the "
                             "reference runs detect_anomaly always; here it "
                             "is opt-in)")


class TrainProfiler:
    """The profiling state of one trainer run: with ``mode`` 'simple' a
    `StepTimer` by section, with 'trace' a `torch.profiler` trace into
    ``<results_dir>/trace``; ``debug_nan`` turns anomaly detection on until
    :meth:`finish`.  Without a mode the sections time nothing.

    Under 'simple' each section ends with a synchronize of a CUDA
    ``device``, so that a section's time holds the device work it queued."""

    def __init__(self, results_dir: str, mode: Optional[str] = None, *,
                 debug_nan: bool = False, device=None):
        self.debug_nan = debug_nan
        if debug_nan:
            enable_anomaly_detection(True)
        self.mode = mode
        self.timer = StepTimer()
        self.trace_dir = os.path.join(results_dir, "trace")
        device = torch.device(device) if device is not None else None
        self._sync = device if device is not None and \
            device.type == "cuda" else None
        self._trace = None
        if self.mode == "trace":
            self._trace = contextlib.ExitStack()
            self._trace.enter_context(trace(self.trace_dir))

    @contextlib.contextmanager
    def _timed(self, name: str):
        with self.timer(name):
            yield
            if self._sync is not None:
                torch.cuda.synchronize(self._sync)

    def section(self, name: str) -> contextlib.AbstractContextManager:
        if self.mode == "simple":
            return self._timed(name)
        return contextlib.nullcontext()

    @classmethod
    def from_args(cls, args: Namespace, results_dir: str, device=None
                  ) -> "TrainProfiler":
        """From the flags of :func:`add_profiler_args`."""
        return cls(results_dir, args.profiler, debug_nan=args.debug_nan,
                   device=device)

    def finish(self) -> None:
        if self.debug_nan:
            enable_anomaly_detection(False)
        if self._trace is not None:
            self._trace.close()
            self._trace = None
            print("profiler trace written to", self.trace_dir, flush=True)
        if self.mode == "simple":
            print(self.timer.summary(), flush=True)


def correction_train_loop(
    projector: torch.nn.Module, state, step_for_epoch: Callable[[int],
                                                                Callable],
    epoch_batches: Callable[[], Iterable[Dict[str, np.ndarray]]],
    keys: Sequence[str], *, results_dir: str, epochs: int, ckpt_every: int,
    generator: Optional[torch.Generator] = None,
    on_step: Optional[Callable] = None, log: Optional[Sequence[str]] = None,
    profiler: Optional["TrainProfiler"] = None,
    on_epoch: Optional[Callable] = None, mesh: Optional[DataMesh] = None
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
    ``profiler`` times the sections ``batch_place`` and ``train_step`` (no
    prefetch: the JAX correction trainers have none).  ``on_epoch(epoch,
    the epoch's last raw batch or None, state)`` runs after every epoch.
    With a data ``mesh`` the steps are `train/trainer.py::
    data_parallel_step`s, each rank places its rows of every batch, and
    rank 0 alone logs, prints, saves and runs ``on_epoch`` while the other
    ranks wait (`parallel/mesh.py::wait_for_rank0`).
    Returns (state, {"steps", "loss": the last step's})."""
    device = next(projector.parameters()).device
    rank0 = is_rank0(mesh)
    prof = profiler if profiler is not None else TrainProfiler(results_dir)
    ckpt = CheckpointManager(os.path.join(results_dir, "ckpt")) \
        if rank0 else None
    logger = MetricsLogger(os.path.join(results_dir, "metrics.jsonl")) \
        if rank0 else None
    i, metrics = 0, None
    try:
        for epoch in range(epochs):
            step = step_for_epoch(epoch)
            batch = None
            for batch in epoch_batches():
                with prof.section("batch_place"):
                    placed = place_batch(batch, device, keys) \
                        if mesh is None else step.place_batch(batch, keys)
                with prof.section("train_step"):
                    state, metrics = step(state, placed, generator,
                                          float(epoch))
                if i % 10 == 0 and rank0:
                    logger.log(i, {k: metrics[k] for k in (log or metrics)},
                               epoch=epoch)
                    print(f"step {i} loss {float(metrics['loss']):.4f}",
                          flush=True)
                i += 1
                if on_step is not None:
                    on_step(i, state, metrics)
            if rank0 and metrics is not None and (
                    (epoch + 1) % ckpt_every == 0 or epoch + 1 == epochs):
                ckpt.save(i, projector.state_dict(),
                          val_loss=float(metrics["loss"]))
            if on_epoch is not None and rank0:
                on_epoch(epoch, batch, state)
            # the other ranks wait for rank 0's saves and renders outside
            # the collectives of the next epoch's steps
            wait_for_rank0(mesh)
    finally:
        prof.finish()
    if rank0:
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


def find_object_mesh(motion_path: str, obj_name: str) -> Optional[str]:
    """The simplified object mesh of a sequence's category, where the
    reference renders it from (`eval_smpl_short.py:317-327`, the map at
    `data/utils.py:18-62`): ``<objects root>/<cat>/<cat>_f1000.ply`` with
    the objects tree beside the sequence directory.  None when it is not on
    disk (the object is then drawn as point spheres)."""
    base = os.path.dirname(os.path.abspath(motion_path).rstrip("/"))
    cand = os.path.join(base, "objects", obj_name, f"{obj_name}_f1000.ply")
    return cand if os.path.isfile(cand) else None


def load_object_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (vertices [Vm, 3] float32 in the object's canonical frame, the
    frame the sampled ``obj_points`` template lies in; faces [F, 3]
    int32)."""
    from interdiff_torch.data.mesh_io import load_mesh

    mesh = load_mesh(path)
    return (np.asarray(mesh.vertices, np.float32),
            np.asarray(mesh.faces, np.int32))


def check_obj_mesh(parser: ArgumentParser, path: Optional[str]) -> None:
    """Stop at the flags when ``--obj_mesh`` names no readable mesh file,
    before any model is built."""
    if path is None:
        return
    if os.path.splitext(path)[1].lower() not in (".obj", ".ply"):
        parser.error(f"--obj_mesh {path}: not an .obj or .ply file")
    if not os.path.isfile(path):
        parser.error(f"--obj_mesh {path}: no such file")


def check_render_interval(parser: ArgumentParser, interval: int) -> None:
    if interval < 0:
        parser.error("--render_interval must be 0 or more")


def render_body_object(path: str, verts: np.ndarray, faces: np.ndarray,
                       obj_rot: np.ndarray, obj_trans: np.ndarray,
                       template: np.ndarray,
                       obj_faces: Optional[np.ndarray], *,
                       past_len: int) -> np.ndarray:
    """A four-view mesh gif of one clip (`viz/mesh_viz.py`): the body
    (verts [T, V, 3], faces) and the object, its template [P, 3] rotated by
    ``obj_rot`` [T, 3, 3] and moved by ``obj_trans`` [T, 3] (a mesh with
    ``obj_faces``, point spheres without); host numpy in, frames [T, 3, H,
    4W] out."""
    from interdiff_torch.viz.mesh_viz import visualize_body_obj

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    obj_verts = np.einsum("tij,pj->tpi", obj_rot, template) \
        + obj_trans[:, None]
    frames = visualize_body_obj(verts, faces, obj_verts, obj_faces,
                                past_len=past_len, save_path=path)
    print("rendered", path, flush=True)
    return frames


def render_smpl_sample(cfg, smpl: SmplModel, out: Dict[str, torch.Tensor],
                       template: np.ndarray,
                       obj_mesh: Optional[Tuple[np.ndarray, np.ndarray]],
                       path: str) -> np.ndarray:
    """The gif of the first row of a postprocessed sample ``out``
    (`interdiff_tpu/cli/eval_smpl_short.py:312-337`): the future frames'
    seam smoothed (before the gif only, as the reference does), the object
    as ``obj_mesh`` (its vertices, faces) under the predicted pose, or as
    spheres of the template cloud [P, 3] without it.  ``cfg`` gives the
    past and future lengths.  Returns the frames."""
    from interdiff_torch.eval.metrics import smooth_seam
    from interdiff_torch.geometry.rotations import axis_angle_to_matrix

    verts = smooth_seam(out["verts"][:1], cfg.future_len)[0]
    obj = smooth_seam(out["obj_pred"][:1], cfg.future_len)[0]
    rot = axis_angle_to_matrix(obj[:, :3])
    tpl, obj_faces = obj_mesh if obj_mesh is not None else (template, None)
    return render_body_object(
        path, verts.cpu().numpy(), smpl.faces, rot.cpu().numpy(),
        obj[:, 3:].cpu().numpy(), tpl, obj_faces, past_len=cfg.past_len)
