"""The span-and-counter recorder (`interdiff_torch/utils/profiling.py`) on
the eval path, on the CPU at tiny sizes: the span tree of an SMPL and a
skeleton `evaluate` in its traced mode (``timings`` given), the hook's
firings, the counters, the off path (no object, no CUDA event, no profiler
range), the spans' host stamps against their `torch.profiler` ranges on the
profiler's clock, a profiler started and stopped inside open spans, the
collector's spans and the `timed` helper behind ``timings``."""

import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from interdiff_torch.cli import eval_skeleton, eval_smpl_short  # noqa: E402
from interdiff_torch.cli.common import (  # noqa: E402
    synthetic_skeleton_batches,
    synthetic_smpl_batches,
    synthetic_smpl_body,
)
from interdiff_torch.config import (  # noqa: E402
    CorrectionConfig,
    DiffusionConfig,
    SkeletonTrackConfig,
    SmplTrackConfig,
)
from interdiff_torch.data.constants import MARKERSET_SSM67_SMPLH  # noqa: E402
from interdiff_torch.eval.skeleton import SkeletonEvalConfig  # noqa: E402
from interdiff_torch.eval.smpl_short import (  # noqa: E402
    SmplEvalConfig,
    make_sampler,
)
from interdiff_torch.utils import profiling  # noqa: E402

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=2)
STEPS, B = 10, 2
SMPL_FIRES = [9, 6, 3, 0]  # t_max 9, every 3
SKELETON_FIRES = [5, 0]  # t_max 5, every 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smpl():
    torch.manual_seed(0)
    track = SmplTrackConfig(**SMALL, diffusion=DiffusionConfig(
        timestep_respacing=str(STEPS)))
    rng = np.random.default_rng(5)
    return dict(
        model=track.build_model("cpu"),
        diffusion=track.diffusion.build("cpu"),
        body=synthetic_smpl_body(rng, device="cpu"),
        projector=CorrectionConfig().build_model("cpu"),
        batch=next(synthetic_smpl_batches(rng, batch_size=B, seq_len=35,
                                          num_points=64, steps=1)),
        cfg=SmplEvalConfig(correction_t_max=9, correction_every=3))


@pytest.fixture(scope="module")
def skeleton():
    torch.manual_seed(1)
    return dict(
        model=SkeletonTrackConfig(**SMALL).build_model("cpu"),
        diffusion=DiffusionConfig(timestep_respacing=str(STEPS)).build("cpu"),
        projector=CorrectionConfig(track="skeleton", num_nodes=21,
                                   future_len=10).build_model("cpu"),
        batch=next(synthetic_skeleton_batches(np.random.default_rng(6),
                                              batch_size=B, seq_len=20,
                                              steps=1)),
        cfg=SkeletonEvalConfig(correction_t_max=5, correction_every=5))


def _smpl_eval(s, timings=None, **kw):
    return eval_smpl_short.evaluate(
        s["cfg"], s["model"], s["diffusion"], s["body"], [s["batch"]],
        projector=s["projector"], diverse_samples=2, diverse_fold=2,
        markers_idx=np.minimum(MARKERSET_SSM67_SMPLH, 127),
        generator=torch.Generator().manual_seed(3), timings=timings,
        report=lambda nb, running: None, **kw)


def _skeleton_eval(s, timings=None, **kw):
    return eval_skeleton.evaluate(
        s["cfg"], s["model"], s["diffusion"], [s["batch"]],
        projector=s["projector"], generator=torch.Generator().manual_seed(4),
        timings=timings, report=lambda nb, running: None, **kw)


def _by_id(session):
    return {p.id: p for p in session.spans}


def _ancestors(span, by_id):
    names = []
    while span.parent is not None:
        span = by_id[span.parent]
        names.append(span.name)
    return names


@pytest.mark.parametrize("track", ["smpl", "skeleton"])
def test_the_span_tree_of_a_traced_evaluate(request, track):
    s = request.getfixturevalue(track)
    timings = {}
    if track == "smpl":
        _smpl_eval(s, timings)
        parts = {"encode", "postprocess", "sampler", "metrics"}
        fires = SMPL_FIRES
        hook = {"hook.gate", "hook.projector", "hook.blend"}
    else:
        _skeleton_eval(s, timings)
        parts, fires = {"encode", "sampler", "metrics"}, SKELETON_FIRES
        hook = {"hook.projector", "hook.blend"}
    assert set(timings) == parts  # the keys of the untraced code
    session = profiling.last_session()
    by_id = _by_id(session)
    (batch,) = [p for p in session.spans if p.name == "eval.batch"]
    assert batch.attrs == {"b": 0} and batch.parent is None
    steps = [p for p in session.spans if p.name == "sampler.step"]
    assert [p.attrs["t"] for p in steps] == list(range(STEPS - 1, -1, -1))
    denoise = [p for p in session.spans if p.name == "sampler.denoise"]
    assert len(denoise) == STEPS
    for p in denoise:
        assert _ancestors(p, by_id) == ["sampler.step", "eval.sampler",
                                        "eval.batch"]
    for p in session.spans:
        if p.name != "host.gc":
            assert p.batch == batch.id
            assert batch.start_ns <= p.start_ns <= p.end_ns <= batch.end_ns
            # CPU time on the batch and its parts, not in the step loop
            if p.name.startswith("eval."):
                assert p.cpu_start_ns <= p.cpu_end_ns
            else:
                assert p.cpu_start_ns is None and p.cpu_end_ns is None
            assert p.device_ms is None  # no CUDA events on the CPU
    firings = [p for p in session.spans if p.name == "hook.firing"]
    assert [p.attrs["t"] for p in firings] == fires
    for p in firings:
        assert by_id[p.parent].name == "sampler.step"
        assert by_id[p.parent].attrs["t"] == p.attrs["t"]
        assert {c.name for c in session.spans if c.parent == p.id} == hook
    if track == "smpl":
        gates = [p for p in session.spans if p.name == "hook.gate"]
        for g in gates:
            assert [c.name for c in session.spans if c.parent == g.id] == [
                "hook.fk", "hook.normals", "hook.k2", "hook.k4"]
    # the parts' spans hold what timings adds up
    for part in parts:
        spans = [p for p in session.spans if p.name == "eval." + part]
        assert sum(p.seconds for p in spans) == pytest.approx(
            timings[part], rel=1e-9)


def test_the_off_path_records_nothing(smpl, monkeypatch):
    """No session and no profiler: no span object, no CUDA event, no
    profiler range, and the last session stays the one it was."""

    def refused(*a, **k):
        raise AssertionError("constructed off the recorder's path")

    before = profiling.last_session()
    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(profiling, "Span", refused)
    totals, nb = _smpl_eval(smpl)
    assert nb == 1 and totals
    assert profiling.last_session() is before
    assert profiling.span("sampler.step", cuda=True, t=3) is \
        profiling.NO_SPAN
    profiling.count("hook.rows", 5)  # nothing to add it to
    assert not profiling.recording()


def test_spans_sit_on_their_profiler_ranges(skeleton):
    """Host stamps, on the profiler's clock, within 100 us of the
    `record_function` events the spans opened (the collector held off: a
    young collection between a stamp and its range's end takes as long)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as warm:
        _skeleton_eval(skeleton)  # the profiler's first ranges cost more
    del warm
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _skeleton_eval(skeleton, timings={})
    finally:
        gc.enable()
    start = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in prof.events():
        ranges.setdefault(e.name, []).append(
            (start + 1000 * e.time_range.start,
             start + 1000 * e.time_range.end))
    session = profiling.last_session()
    names = {p.name for p in session.spans} - {"host.gc"}
    assert {"eval.batch", "sampler.step", "sampler.denoise",
            "hook.firing"} <= names
    for name in names:
        spans = sorted((p.start_ns, p.end_ns) for p in session.spans
                       if p.name == name)
        events = sorted(ranges[name])
        assert len(events) == len(spans), name
        for (s0, s1), (e0, e1) in zip(spans, events):
            assert abs(s0 - e0) < 100_000 and abs(s1 - e1) < 100_000, name


def test_a_profiler_inside_open_spans_leaves_all_sound(skeleton):
    """The benchmark's recorder stops a profiler, and starts another,
    inside the denoiser: spans opened under one profiler close under none
    or under the next.  The sample, the session and both traces stay
    whole."""
    from torch.profiler import ProfilerActivity, profile

    want = []
    _skeleton_eval(skeleton, forecasts=want)
    model = skeleton["model"]
    denoise, calls, traces = model.denoise, [0], []
    prof = [profile(activities=[ProfilerActivity.CPU])]

    def switching(*a, **k):
        calls[0] += 1
        if calls[0] in (3, 7):  # stop inside a step, start in a later one
            prof[0].stop()
            traces.append(len(prof[0].events()))
        if calls[0] in (5, 9):
            prof[0] = profile(activities=[ProfilerActivity.CPU])
            prof[0].start()
        return denoise(*a, **k)

    got = []
    model.denoise = switching
    try:
        for _ in range(3):
            calls[0] = 0
            prof[0] = profile(activities=[ProfilerActivity.CPU])
            prof[0].start()
            _skeleton_eval(skeleton, timings={}, forecasts=got)
            prof[0].stop()
            traces.append(len(prof[0].events()))
    finally:
        model.denoise = denoise
    assert len(traces) == 9 and all(n > 0 for n in traces)
    for f in got:
        for k in f:
            torch.testing.assert_close(f[k], want[0][k], rtol=0, atol=0)
    session = profiling.last_session()
    assert all(p.end_ns is not None for p in session.spans)
    assert sum(p.name == "sampler.step" for p in session.spans) == STEPS
    # ranges stranded by a profiler's restart end at the next span's edge
    # with no profiler recording
    assert profiling.span("after") is profiling.NO_SPAN
    assert not profiling.recording() and not profiling._REC.stranded


def test_sampler_ops_repeat_call_to_call(smpl):
    """The second step of each sampler call, counted by the dispatch
    mode: the same count in every call, under a profiler too."""
    with profiling.session() as session:
        for _ in range(2):
            _smpl_eval(smpl)
    assert session.calls["sampler.ops"] == 2
    per_call = session.counters["sampler.ops"] / 2
    with profiling.session() as again:
        _smpl_eval(smpl)
    assert again.counters["sampler.ops"] == per_call > 100
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]), \
            profiling.session() as profiled:
        _smpl_eval(smpl)  # the ranges' own operators are not counted
    assert profiled.counters["sampler.ops"] == per_call
    counted = [p for p in session.spans if p.name == "sampler.step"
               and p.attrs["t"] == STEPS - 2]
    assert len(counted) == 2


def test_corrected_rows_are_the_gates_conditions(smpl):
    s = smpl
    trace = []
    sample = make_sampler(s["cfg"], s["model"], s["diffusion"],
                          smpl=s["body"], projector=s["projector"],
                          markers_idx=np.minimum(MARKERSET_SSM67_SMPLH, 127),
                          trace=trace)
    b = {k: torch.as_tensor(v) for k, v in s["batch"].items()}
    from interdiff_torch.models.mdm_smpl import smpl_gt_from_raw

    gt = smpl_gt_from_raw(b["body_pose"][..., :66], b["body_trans"],
                          b["obj_angles"], b["obj_trans"])
    with profiling.session() as session:
        sample(gt, b["obj_points"][..., :6], b["body_pose"][..., 66:],
               b["body_betas"], generator=torch.Generator().manual_seed(2))
    assert [e["t"] for e in trace] == SMPL_FIRES
    assert "start" not in trace[0]  # CUDA events on the card only
    assert session.counters["hook.rows"] == B * len(SMPL_FIRES)
    assert session.calls["hook.rows_corrected"] == len(SMPL_FIRES)
    assert session.counters["hook.rows_corrected"] == sum(
        int(e["condition"].sum()) for e in trace)


def test_the_collector_is_a_span():
    with profiling.session() as session:
        with profiling.span("outer", k=1):
            gc.collect(1)
    (outer,) = [p for p in session.spans if p.name == "outer"]
    runs = [p for p in session.spans if p.name == "host.gc"]
    assert outer.attrs == {"k": 1}
    assert any(p.attrs == {"generation": 1} and p.parent == outer.id
               for p in runs)
    assert all(p.end_ns >= p.start_ns and p.cpu_end_ns >= p.cpu_start_ns
               for p in runs)
    assert session._gc not in gc.callbacks


def test_sessions_nest_into_the_open_one_and_counters_sum():
    with profiling.session() as outer:
        with profiling.session() as inner:
            assert inner is outer
            profiling.count("n", 2)
            profiling.count("n", torch.tensor(3))
        assert profiling.recording()
    assert not profiling.recording()
    assert profiling.last_session() is outer
    assert outer.counters == {"n": 5} and outer.calls == {"n": 2}
    with profiling.session(False) as none:
        assert none is None and not profiling.recording()


def test_timed_adds_a_parts_seconds_without_a_session():
    """`cli/optimization.py` times its parts with no session open."""
    import time

    timings = {}
    for _ in range(2):
        out = profiling.timed(timings, torch.device("cpu"), "opt.refine",
                              lambda x: (time.sleep(0.002), x + 1)[1], 1)
    assert out == 2 and set(timings) == {"refine"}
    assert 0.004 <= timings["refine"] < 1.0
    assert profiling.timed(None, torch.device("cpu"), "opt.refine",
                           lambda: 7) == 7


def test_a_capturing_stream_gets_host_times_only(monkeypatch):
    """While the current stream captures a CUDA graph: no CUDA event, no
    counting mode, host stamps as ever."""

    def refused(*a, **k):
        raise AssertionError("an event or a mode inside a capture")

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(profiling, "_OpCount", refused)
    with profiling.session() as session:
        with profiling.span("sampler.step", cuda=True, ops="sampler.ops",
                            t=7) as step:
            torch.ones(3).sum()
    assert step.events is None and step.device_ms is None
    assert step.end_ns >= step.start_ns and "sampler.ops" not in \
        session.counters
