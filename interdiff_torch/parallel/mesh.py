"""Data parallelism over ranks (`interdiff_tpu/parallel/mesh.py`, and the
device-count rule of `interdiff_tpu/cli/common.py::make_mesh`).

The JAX package replicates the parameters, shards the global batch over a
mesh's ``data`` axis and lets XLA insert the gradient psum.  Here a mesh is
a set of processes, one a device (a *rank*), joined by a
`torch.distributed` process group: NCCL on CUDA devices, gloo on the CPU.
Every rank holds the parameters (`replicated` broadcasts rank 0's once at
start) and is handed its own contiguous rows of the global batch
(`shard_batch`, rows ``[r*B/W, (r+1)*B/W)``, as ``PartitionSpec("data")``
lays them out).  Where JAX's jitted step takes the global array, each rank
here passes its wrapped step its own rows, as every torch.distributed
program does.

A mesh acts inside :func:`use_mesh`: there the BatchNorm statistics in train
mode (`models/layers.py::BatchNormState`), the train steps' loss, gradients
and metrics (`train/trainer.py`) and every draw of a per-row tensor from the
shared generator (:func:`draw_rows`) take the global batch into account, so
that W ranks compute what one rank does on the whole batch.  Outside it
nothing changes.

Collectives.  Every collective on a device tensor is an all-reduce (SUM) or
a broadcast, the two that gloo also carries on CUDA tensors; an all-gather
is an all-reduce of each rank's rows placed in a zero buffer
(:func:`all_gather_rows`), exact since a sum with zeros rounds nothing.  A
mesh of one rank without a process group skips the communication.

Launching (:func:`launch`): under ``torchrun`` the process group comes from
its environment; otherwise W ranks are spawned (the ``spawn`` start method:
CUDA does not survive ``fork``) and meet through a ``file://`` rendezvous in
a directory the caller names (a fresh temporary one by default).  A rank
that fails stops the others.  A run has no deadline of its own and its
collectives keep torch's default limit unless the caller names shorter
ones, as the tests do.  Where rank 0 works alone (a validation, checkpoints,
renders), the other ranks wait for it in :func:`wait_for_rank0`, outside
every collective.  A failure to set up NCCL raises: nothing falls back to
gloo or the CPU.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from interdiff_torch import full_f32

# how long the other ranks wait for rank 0's work alone (a validation with
# the full schedule, checkpoints, renders) in `wait_for_rank0`; a rank that
# dies is stopped by its launcher (`launch`, torchrun), not by this limit
RANK0_WAIT_S = 24 * 3600.0
# how long `launch` waits for its ranks to exit once each has its result
_EXIT_S = 60.0


@dataclass
class DataMesh:
    """One rank's view of a 1-D data mesh: its ``rank`` among ``size`` ranks,
    the ``device`` it computes on, the process ``group`` (None for a
    mesh of one rank that communicates with nobody) and the gloo group
    ``wait_group`` of :func:`wait_for_rank0`."""

    rank: int
    size: int
    device: torch.device
    group: Any = None
    wait_group: Any = None
    _streams: Dict[Any, torch.Generator] = field(default_factory=dict,
                                                 repr=False)

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """SUM over the ranks, in place; ``x`` lies on the mesh's device."""
        if self.group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def broadcast_(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place."""
        if self.group is not None:
            # a mesh's ranks are the world's first ones: group rank = rank
            dist.broadcast(x, src=src, group=self.group)
        return x

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n * size`` global rows."""
        return slice(self.rank * n, (self.rank + 1) * n)

    def rank_stream(self, generator: Optional[torch.Generator],
                    device) -> torch.Generator:
        """A generator of this rank's own, on ``device``, for draws that no
        two ranks may share (dropout masks); seeded from ``generator``'s
        seed and the rank, made once and then advanced by its draws."""
        device = torch.device(device)
        key = (device.type, device.index)
        if key not in self._streams:
            base = (generator.initial_seed() if generator is not None
                    else torch.initial_seed())
            self._streams[key] = torch.Generator(device=device).manual_seed(
                (base * 1_000_003 + 7_919 * (self.rank + 1)) % (2 ** 63))
        return self._streams[key]


# ---------------------------------------------------------------------------
# the active mesh
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "interdiff_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[DataMesh]):
    """Make ``mesh`` the active mesh inside the block (None: no mesh)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[DataMesh]:
    return _ACTIVE.get()


def draw_rows(draw: Callable[[int], Any], rows: int):
    """``draw(n)`` draws a tensor (or a tuple of tensors) of ``n`` rows from
    the shared generator.  Under an active mesh of W ranks it is called with
    ``n = rows * W`` and this rank's rows are returned, so that a rank's
    draws equal those of one rank on the global batch row for row;
    otherwise it is ``draw(rows)``."""
    mesh = active_mesh()
    if mesh is None or mesh.size == 1:
        return draw(rows)
    out = draw(rows * mesh.size)
    sl = mesh.rows(rows)
    if isinstance(out, tuple):
        return tuple(o[sl] for o in out)
    return out[sl]


def randn_rows(shape: Sequence[int], generator: Optional[torch.Generator],
               device, dtype=torch.float32) -> torch.Tensor:
    """``torch.randn(shape)`` through :func:`draw_rows` (rows on axis 0)."""
    shape = tuple(shape)
    return draw_rows(lambda n: torch.randn(
        (n,) + shape[1:], generator=generator, device=device, dtype=dtype),
        shape[0])


# ---------------------------------------------------------------------------
# building a mesh
# ---------------------------------------------------------------------------

def data_ranks(batch_size: Optional[int], available: int, *,
               quiet: bool = False) -> int:
    """The largest count of ranks, at most ``available``, that divides
    ``batch_size`` (all of them without one), with the JAX package's
    message when it is fewer (unless ``quiet``): a global batch must shard
    evenly."""
    n = available
    if batch_size is not None:
        while n > 1 and batch_size % n:
            n -= 1
        if n < available and not quiet:
            print(f"batch {batch_size} not divisible by {available} "
                  f"devices; data mesh uses {n}", flush=True)
    return n


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or the CUDA device of its local rank
    (``LOCAL_RANK`` under torchrun) among the visible ones."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def process_device(device) -> torch.device:
    """This process's device: :func:`rank_device` of its rank in the
    process group, or ``device`` itself without one."""
    if not dist.is_initialized():
        return torch.device(device)
    return rank_device(device, dist.get_rank())


def make_mesh(data: Optional[int] = None, *,
              batch_size: Optional[int] = None, device=None
              ) -> Optional[DataMesh]:
    """This rank's mesh over the ranks of the process group (one rank, with
    no group, when none is set up).

    ``data``: the number of ranks to use (all when None).  ``batch_size``:
    when given, only the largest count of ranks that divides it is used
    (:func:`data_ranks`); a rank that rule leaves out gets None and has no
    rows to compute.  ``device``: 'cuda' (the default; each rank takes the
    card of its local rank) or 'cpu'."""
    device = torch.device("cuda" if device is None else device)
    if not dist.is_initialized():
        if data not in (None, 1):
            raise ValueError(
                f"a mesh of {data} ranks needs {data} processes: start them "
                "with parallel.mesh.launch or torchrun")
        return DataMesh(0, 1, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is not None and data > world:
        raise ValueError(f"a mesh of {data} ranks in a process group of "
                         f"{world}")
    n = world if data is None else data
    n = data_ranks(batch_size, n, quiet=rank > 0)
    # every rank of the world takes part in each new_group
    group = dist.group.WORLD if n == world else dist.new_group(
        list(range(n)))
    wait_group = dist.new_group(
        list(range(n)), backend="gloo",
        timeout=datetime.timedelta(seconds=RANK0_WAIT_S))
    if rank >= n:
        return None
    return DataMesh(rank, n, rank_device(device, rank), group, wait_group)


def shard_batch(batch, mesh: Optional[DataMesh], *, axis: int = 0):
    """This rank's contiguous rows of a global batch (a dict, tuple or list
    of tensors or arrays, or one of them), on ``axis``; the batch itself
    without a mesh or at one rank."""
    if mesh is None or mesh.size == 1:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis=axis) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh, axis=axis) for v in batch)
    n = batch.shape[axis]
    if n % mesh.size:
        raise ValueError(f"{n} rows on axis {axis} do not shard over "
                         f"{mesh.size} ranks")
    index = [slice(None)] * batch.ndim
    index[axis] = mesh.rows(n // mesh.size)
    return batch[tuple(index)]


def replicated(tensors, mesh: Optional[DataMesh]) -> None:
    """Broadcast rank 0's values of a module's parameters and buffers (or
    of an iterable of tensors) to every rank, in place: the start of a
    data-parallel run, and a checkpoint that rank 0 alone read (the other
    ranks first wait for it in :func:`wait_for_rank0`)."""
    if mesh is None or mesh.group is None:
        return
    wait_for_rank0(mesh)
    if isinstance(tensors, torch.nn.Module):
        tensors = list(tensors.parameters()) + list(tensors.buffers())
    with torch.no_grad():
        for t in tensors:
            if t.device == mesh.device:
                mesh.broadcast_(t.data)
            else:
                buf = t.data.to(mesh.device)
                t.data.copy_(mesh.broadcast_(buf))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks whose backward SUMs the cotangent over the ranks:
    each rank's objective depends on every rank's input through the sum."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.contiguous().clone()), None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[DataMesh]
                   ) -> torch.Tensor:
    """The differentiable SUM of ``x`` over the mesh's ranks (``x`` itself
    without a process group)."""
    if mesh is None or mesh.group is None:
        return x
    return _AllReduceSum.apply(x, mesh)


def all_reduce_grads(params: Iterable[torch.Tensor],
                     mesh: Optional[DataMesh]) -> None:
    """SUM the ``.grad`` of every parameter that has one over the ranks, in
    one flattened buffer (every rank has the same parameters with a
    gradient, since each runs the same graph).  Each ``.grad`` becomes a
    view of the summed buffer: no copy back, one launch per tensor fewer."""
    if mesh is None or mesh.group is None:
        return
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = mesh.all_reduce_(torch.cat([p.grad.reshape(-1) for p in params]))
    offset = 0
    for p in params:
        n = p.grad.numel()
        p.grad = flat[offset:offset + n].view_as(p.grad)
        offset += n


def all_gather_rows(x: torch.Tensor, mesh: Optional[DataMesh]
                    ) -> torch.Tensor:
    """Every rank's ``x`` [n, ...] (the same shape on every rank) stacked in
    rank order, [n * W, ...], on ``x``'s device: each rank's rows in their
    slot of a zero buffer on the mesh's device, SUMmed over the ranks."""
    if mesh is None or mesh.group is None:
        return x
    n = x.shape[0]
    buf = torch.zeros((n * mesh.size,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=mesh.device)
    buf[mesh.rows(n)] = x.to(mesh.device)
    return mesh.all_reduce_(buf).to(x.device)


def mean_metrics(metrics: Dict[str, torch.Tensor],
                 mesh: Optional[DataMesh]) -> Dict[str, torch.Tensor]:
    """The mean over the ranks of each metric (0-d or stacked [K]), in one
    all-reduce: with equal shards, the global batch's mean."""
    if mesh is None or mesh.group is None or not metrics:
        return metrics
    names = list(metrics)
    stacked = torch.stack([metrics[k].to(mesh.device, torch.float32)
                           for k in names])
    stacked = mesh.all_reduce_(stacked) / mesh.size
    return {k: stacked[i].to(metrics[k].device)
            for i, k in enumerate(names)}


def wait_for_rank0(mesh: Optional[DataMesh]) -> None:
    """Hold every rank here until rank 0 arrives, after work that rank 0
    does alone (a validation, checkpoints, renders, a checkpoint read): a
    barrier of the mesh's gloo ``wait_group``, whose limit is
    RANK0_WAIT_S, so that no collective of the mesh waits on that work
    under its own, shorter limit."""
    if mesh is None or mesh.wait_group is None:
        return
    dist.barrier(group=mesh.wait_group)


def sync_generator(generator: Optional[torch.Generator],
                   mesh: Optional[DataMesh]) -> None:
    """Rank 0's state of the shared generator on every rank (after rank 0
    alone drew from it, as a validation does)."""
    if generator is None or mesh is None or mesh.group is None:
        return
    state = generator.get_state().to(mesh.device)
    generator.set_state(mesh.broadcast_(state).cpu())


# ---------------------------------------------------------------------------
# launching ranks
# ---------------------------------------------------------------------------

def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _pin_settings(threads: int, fused_sa: Optional[str]) -> None:
    """What a spawned rank does not inherit from its parent's interpreter."""
    torch.set_num_threads(threads)
    full_f32()
    if fused_sa is None:
        os.environ.pop("INTERDIFF_FUSED_SA", None)
    else:
        os.environ["INTERDIFF_FUSED_SA"] = fused_sa


def _init_group(backend: str, device, collective_timeout: Optional[float],
                **kwargs) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        rank = kwargs.get("rank", int(os.environ.get("RANK", 0)))
        torch.cuda.set_device(rank_device(device, rank))
    if collective_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=collective_timeout)
    dist.init_process_group(backend, **kwargs)


def _rank_main(rank: int, world: int, init_file: str, backend: str, device,
               collective_timeout: Optional[float], settings: tuple,
               fn: Callable, args: tuple, results) -> None:
    try:
        _pin_settings(*settings)
        _init_group(backend, device, collective_timeout,
                    init_method=f"file://{init_file}", world_size=world,
                    rank=rank)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # plain pickle bytes: a queue would share a tensor's storage with a
        # process that exits before its parent reads it
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def launch(fn: Callable, world: int, *, args: tuple = (), device="cuda",
           backend: Optional[str] = None, init_dir: Optional[str] = None,
           timeout: Optional[float] = None,
           collective_timeout: Optional[float] = None) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks and return each rank's result
    in rank order.

    Under torchrun (``WORLD_SIZE`` in the environment) this process is one
    rank: the group is set up from the environment and the list holds this
    rank's result alone.  One rank runs in this process, without a group.
    Otherwise ``world`` processes are spawned (``fn`` and ``args`` must
    pickle), each with torch's thread count, TF32 off and
    ``INTERDIFF_FUSED_SA`` as here, meeting through ``file://`` in
    ``init_dir`` (a fresh temporary directory when None, removed after).
    ``backend``: NCCL for CUDA, gloo for the CPU, unless named (gloo on CUDA
    tensors carries all-reduce and broadcast, which two ranks on one card
    need).  A rank that raises or exits non-zero stops the others and
    raises RuntimeError here; so does ``timeout`` seconds without all the
    results (no deadline when None, as a training run needs).
    ``collective_timeout``: the process group's limit on one collective, in
    seconds (torch's default when None); a test names a short one, so that
    a peer that died does not leave the others blocked for long."""
    backend = backend or _backend(device)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        _init_group(backend, device, collective_timeout,
                    init_method="env://")
        try:
            return [fn(*args)]
        finally:
            dist.destroy_process_group()
    if world == 1:
        return [fn(*args)]
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    own_dir = init_dir is None
    init_dir = tempfile.mkdtemp(prefix="rendezvous_") if own_dir \
        else init_dir
    os.makedirs(init_dir, exist_ok=True)
    init_file = os.path.join(init_dir, f"rendezvous_{os.getpid()}_"
                             f"{time.monotonic_ns()}")
    settings = (torch.get_num_threads(),
                os.environ.get("INTERDIFF_FUSED_SA"))
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, init_file, backend, device, collective_timeout, settings,
        fn, args, results),
        daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    failure = None
    try:
        while len(out) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    failure = f"rank(s) exited with {dead}"
                elif deadline is not None and time.monotonic() > deadline:
                    failure = f"no result from every rank in {timeout} s"
                continue
            if ok:
                out[rank] = pickle.loads(value)
            else:
                failure = f"rank {rank} failed:\n{value}"
        for p in procs:
            p.join(timeout=_EXIT_S if failure is None else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        if own_dir:
            shutil.rmtree(init_dir, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"data-parallel launch of {world} ranks: "
                           f"{failure}")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"data-parallel launch: rank(s) exited with {bad}")
    return [out[r] for r in range(world)]


def local_devices(device) -> int:
    """The devices one launch may take: the visible CUDA devices, or the
    CPU's cores (gloo ranks) for ``device='cpu'``."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def is_rank0(mesh: Optional[DataMesh]) -> bool:
    return mesh is None or mesh.rank == 0

