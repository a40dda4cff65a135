"""Tracing, step timing and the NaN sanitizer of the trainers
(`interdiff_tpu/utils/profiling.py`), and the port's span-and-counter
recorder.

  * :class:`StepTimer`: wall-clock totals by section (the reference's
    Lightning SimpleProfiler, `train_diffusion_smpl.py:585,641`);
  * :func:`trace`: a `torch.profiler` trace of the CPU and the CUDA device,
    written as a Chrome trace;
  * :func:`enable_anomaly_detection`: `torch.autograd.set_detect_anomaly`
    behind an explicit call (the reference leaves it on, `:608`);
  * :func:`session`, :func:`span`, :func:`count`, :func:`last_session` and
    :func:`timed`: the recorder.

The recorder.  A session (:func:`session`) keeps in memory every span and
counter recorded while it is open; :func:`last_session` returns the last
one closed.  A span (:func:`span`, a context manager) records its name, id,
parent id, the id of the enclosing ``eval.batch``, its attributes and its
host start and end; where asked, the thread's CPU time at both ends (a
system call each: on a host where a system call in the step loop costs
a few tenths of a millisecond, the per-step spans leave it out); on a CUDA path a
CUDA event pair, turned into device milliseconds once, when the session
closes, behind one synchronize.  Host stamps are read on
``perf_counter_ns`` and, at the close, put on the profiler's clock (Unix
epoch ns, that of `time.time_ns` and of the profiler's
``kineto_results.trace_start_ns()``) by one anchor the session took when
it opened.  A counter (:func:`count`) sums Python ints or 0-d tensors, the
tensors on their device, read once at the close.  While `torch.profiler`
records, every span also opens a `record_function` range of its name, so
that the profiler's trace puts host time, and the device's idle gaps, down
to the innermost span; a range whose profiler stopped, and another
started, before the range closed is ended once none records (the span's
ends see each start: a profiler stopped and restarted with no span edge
between them is not seen).  With no session open and no profiler
recording, :func:`span` returns a shared no-op: no object, no CUDA event,
no range.  While the current stream captures a CUDA graph, spans keep host
times only.  While a session is open, each run of Python's collector is
recorded as a span ``host.gc`` (attribute ``generation``).  Spans nest on
one thread: the eval path's.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def enable_anomaly_detection(enable: bool = True) -> None:
    """NaN/Inf sanitizer: `torch.autograd.set_detect_anomaly(enable,
    check_nan=True)`.

    It differs from the JAX package's ``jax_debug_nans``, which raises at
    the first non-finite *forward* output of a jitted computation: torch's
    detector checks the *backward*.  A backward function that returns a
    NaN gradient raises, with the traceback of the forward operation that
    recorded it; a NaN in a forward output that no backward turns into a
    NaN gradient passes."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """A `torch.profiler` trace of everything inside the context, the CPU's
    operations and (with a CUDA device) the device's kernels, written to
    ``<logdir>/trace.json`` in the Chrome trace format."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock seconds by section, every call kept.

    >>> timer = StepTimer()
    >>> with timer("train_step"):
    ...     out = step(...)
    >>> print(timer.summary())
    """

    def __init__(self):
        self._seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._seconds[name].append(time.perf_counter() - t0)

    def stats(self) -> Dict[str, Dict[str, float]]:
        """{section: {"calls", "total_s", "mean_ms", "median_ms"}}: the
        median is the steady state's where the first call warms up."""
        return {name: {"calls": len(s), "total_s": sum(s),
                       "mean_ms": 1e3 * sum(s) / len(s),
                       "median_ms": 1e3 * statistics.median(s)}
                for name, s in self._seconds.items()}

    def summary(self) -> str:
        rows = ["section | calls | total_s | mean_ms"]
        for name, st in sorted(self.stats().items(),
                               key=lambda kv: kv[1]["total_s"],
                               reverse=True):
            rows.append(f"{name} | {st['calls']} | {st['total_s']:.3f} | "
                        f"{st['mean_ms']:.2f}")
        return "\n".join(rows)

    def reset(self):
        self._seconds.clear()


# -- the span-and-counter recorder ---------------------------------------

BATCH = "eval.batch"  # the span whose id every span inside it carries


def _profiler_records() -> bool:
    """Whether `torch.profiler` records, read where a span is asked for or
    opens and where one with a range closes: each start seen after a stop
    begins a new profiler epoch."""
    on = torch._C._autograd._profiler_enabled()
    if on and not _REC.profiler_on:
        _REC.epoch += 1
    _REC.profiler_on = on
    if not on and _REC.stranded:
        _end_stranded()
    return on


def _end_stranded() -> None:
    """End the ranges whose profiler stopped while they were open and
    another started before they closed: ended under the profiler that
    did not begin them, a range writes into the freed record of the one
    that did.  With no profiler recording, ending one touches nothing."""
    for handle in _REC.stranded:
        handle.__exit__(None, None, None)
    _REC.stranded.clear()


class _OpCount(TorchDispatchMode):
    """Counts the aten operators dispatched while it is active (views
    included: each is dispatch work on the host; the profiler's own range
    operators are not counted)."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # torch would wrap __torch_dispatch__ in dynamo's disable, whose
        # first call imports dynamo (seconds) and whose every call costs
        return False

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.namespace == "aten"
        return func(*args, **(kwargs or {}))


class _NoSpan:
    """What :func:`span` returns when nothing records: enters and leaves."""

    __slots__ = ()
    events = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class Span:
    """One span: ``name``, ``id`` (its index in the session, None outside
    one), ``parent`` (the enclosing span's id), ``batch`` (the enclosing
    ``eval.batch``'s id), ``attrs``, ``start_ns`` and ``end_ns`` (on the
    profiler's clock once the session has closed), ``cpu_start_ns`` and
    ``cpu_end_ns`` (`time.thread_time_ns`, or None where not asked),
    ``events`` (the CUDA event pair, or None) and ``device_ms`` (between
    the events, set at the session's close)."""

    __slots__ = ("name", "attrs", "id", "parent", "batch", "start_ns",
                 "end_ns", "cpu_start_ns", "cpu_end_ns", "events",
                 "device_ms", "_session", "_cuda", "_cpu", "_ops", "_mode",
                 "_range", "_epoch")

    def __init__(self, session: Optional["Session"], name: str,
                 attrs: Dict[str, Any], cuda: bool = False,
                 cpu: bool = False, ops: Optional[str] = None):
        self.name, self.attrs = name, attrs
        self.id = self.parent = self.batch = None
        self.cpu_start_ns = self.cpu_end_ns = None
        self.events = self.device_ms = self._mode = self._range = None
        self._session, self._cuda, self._cpu, self._ops = \
            session, cuda, cpu, ops
        self._epoch = 0

    @property
    def seconds(self) -> float:
        """Host wall seconds."""
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Span":
        if _profiler_records():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            self._epoch = _REC.epoch
        # the wall stamps next to the range's ends, the CPU stamps and the
        # recorder's own work inside them
        self.start_ns = time.perf_counter_ns()
        if self._session is not None:
            self._session._open(self)
        capturing = self._cuda and torch.cuda.is_current_stream_capturing()
        if self._cuda and not capturing:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        if self._ops and not capturing:
            self._mode = _OpCount()
            self._mode.__enter__()
        if self._cpu:
            self.cpu_start_ns = time.thread_time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self._cpu:
            self.cpu_end_ns = time.thread_time_ns()
        if self._mode is not None:
            self._mode.__exit__(None, None, None)
            self._session.add(self._ops, self._mode.n)
            self._mode = None
        if self.events is not None:
            self.events[1].record()
        if self._range is not None:
            if _profiler_records() and self._epoch != _REC.epoch:
                _REC.stranded.append(self._range)
            else:  # under its own profiler, or none
                self._range.__exit__(None, None, None)
            self._range = None
        self.end_ns = time.perf_counter_ns()
        if self._session is not None:
            self._session._close(self)
        return False


class Session:
    """The spans (``spans``, in the order they opened) and counters
    (``counters``: name -> sum; ``calls``: name -> number of additions)
    recorded while it was open."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, Any] = {}
        self.calls: Dict[str, int] = {}
        self._stack: List[Span] = []
        self._batch: Optional[int] = None
        self._gc_start: Optional[Tuple[int, int]] = None
        self._epoch_ns, self._anchor_ns = time.time_ns(), \
            time.perf_counter_ns()

    def _open(self, s: Span) -> None:
        s.id = len(self.spans)
        s.parent = self._stack[-1].id if self._stack else None
        if s.name == BATCH:
            self._batch = s.id
        s.batch = self._batch
        self._stack.append(s)
        self.spans.append(s)

    def _close(self, s: Span) -> None:
        self._stack.pop()
        if s.name == BATCH:
            self._batch = None if s.parent is None \
                else self.spans[s.parent].batch

    def add(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + value
        self.calls[name] = self.calls.get(name, 0) + 1

    def _gc(self, phase: str, info: Dict[str, int]) -> None:
        """`gc.callbacks` hook: each collection a ``host.gc`` span."""
        if phase == "start":
            self._gc_start = (time.perf_counter_ns(), time.thread_time_ns())
            return
        if self._gc_start is None:
            return
        s = Span(None, "host.gc", {"generation": info["generation"]},
                 cpu=True)
        s.start_ns, s.cpu_start_ns = self._gc_start
        s.cpu_end_ns = time.thread_time_ns()
        s.end_ns = time.perf_counter_ns()
        s.id, s.batch = len(self.spans), self._batch
        s.parent = self._stack[-1].id if self._stack else None
        self.spans.append(s)
        self._gc_start = None

    def _finish(self) -> None:
        """Device intervals and device counters read behind one
        synchronize; host stamps onto the profiler's clock."""
        timed = [s for s in self.spans if s.events is not None]
        tensors = [k for k, v in self.counters.items()
                   if isinstance(v, torch.Tensor)]
        if (timed or tensors) and torch.cuda.is_available():
            torch.cuda.synchronize()
        for s in timed:
            s.device_ms = s.events[0].elapsed_time(s.events[1])
        for k in tensors:
            self.counters[k] = self.counters[k].item()
        shift = self._epoch_ns - self._anchor_ns
        for s in self.spans:
            s.start_ns += shift
            s.end_ns += shift


class _Recorder:
    """The process's recorder state: the open and the last closed session,
    and what the spans have seen of the profiler."""

    def __init__(self):
        self.current: Optional[Session] = None
        self.last: Optional[Session] = None
        self.profiler_on = False  # as last seen
        self.epoch = 0  # profiler starts seen
        self.stranded: List[Any] = []  # ranges to end once none records


_REC = _Recorder()


@contextlib.contextmanager
def session(on: bool = True) -> Iterator[Optional[Session]]:
    """Open a session for the duration of the context and yield it; with
    ``on`` false, or inside an open session, open none (and yield the open
    one, or None)."""
    if not on or _REC.current is not None:
        yield _REC.current
        return
    s = _REC.current = Session()
    gc.callbacks.append(s._gc)
    try:
        yield s
    finally:
        gc.callbacks.remove(s._gc)
        _REC.current = None
        s._finish()
        _REC.last = s


def last_session() -> Optional[Session]:
    """The most recent closed session, or None."""
    return _REC.last


def recording() -> bool:
    """Whether a session is open (a counter's value is worth computing)."""
    return _REC.current is not None


def span(name: str, *, cuda: bool = False, cpu: bool = False,
         keep: bool = False, ops: Optional[str] = None, **attrs):
    """A context manager around the work it names.  ``cuda``: the work runs
    on the current CUDA device, so the span records a CUDA event pair
    there; ``cpu``: the span records the thread's CPU time at both ends;
    ``keep``: the span records its host times (and its events) even with
    no session and no profiler, for a caller that reads them itself;
    ``ops``: the name of a counter that gets the number of aten operators
    dispatched inside the span (in a session only)."""
    s = _REC.current
    if s is None and not keep and not _profiler_records():
        return NO_SPAN
    return Span(s, name, attrs, cuda and (s is not None or keep), cpu,
                ops if s is not None else None)


def count(name: str, value) -> None:
    """Add ``value`` (a Python int or a 0-d tensor, summed on its device) to
    the open session's counter ``name``; nothing without a session."""
    if _REC.current is not None:
        _REC.current.add(name, value)


def timed(timings: Optional[Dict[str, float]], device: torch.device,
          name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside the span ``name`` (``<scope>.<part>``,
    with the thread's CPU time).  With ``timings``, ``device`` is
    synchronised before the span and at its end, and the span's wall
    seconds are added to ``timings[part]``."""
    cuda = device.type == "cuda"
    if timings is None:
        with span(name, cuda=cuda, cpu=True):
            return fn(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize(device)
    with span(name, cuda=cuda, cpu=True, keep=True) as part:
        out = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize(device)
    key = name.rsplit(".", 1)[-1]
    timings[key] = timings.get(key, 0.0) + part.seconds
    return out
