"""The trainers' profiler (`interdiff_torch/utils/profiling.py`,
`cli/common.py::{add_profiler_args,TrainProfiler}`) on the CPU: the
`StepTimer` summary is the JAX package's, line for line, on one clock;
`trace` writes a Chrome trace of the CPU's operations; ``--debug_nan``
makes a backward that returns NaN raise, and is off again after the run;
a trainer's ``main`` with ``--profiler simple`` prints both sections, one
with ``--profiler trace`` writes ``<results_dir>/trace``, and the flags are
the JAX package's."""

import json
import os
from argparse import ArgumentParser

import pytest

torch = pytest.importorskip("torch")

from interdiff_tpu.cli import common as jcommon  # noqa: E402
from interdiff_tpu.utils import profiling as jprofiling  # noqa: E402
from interdiff_torch.cli import common as tcommon  # noqa: E402
from interdiff_torch.cli import train_correction_skeleton  # noqa: E402
from interdiff_torch.cli import train_diffusion_smpl  # noqa: E402
from interdiff_torch.utils import profiling  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test processes share the machine's cores,
    and these small ops gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_step_timer_summary_is_the_jax_packages(monkeypatch):
    ticks = iter([0.0, 0.25, 1.0, 1.5, 2.0, 2.125, 3.0, 3.5] * 2)
    clock = lambda: next(ticks)  # noqa: E731
    timers = []
    for module in (profiling, jprofiling):
        monkeypatch.setattr(module.time, "perf_counter", clock)
        timer = module.StepTimer()
        for name in ("batch_place", "train_step", "batch_place",
                     "train_step"):
            with timer(name):
                pass
        timers.append(timer)
    ours, theirs = (t.summary() for t in timers)
    assert ours == theirs
    assert ours.splitlines() == [
        "section | calls | total_s | mean_ms",
        "train_step | 2 | 1.000 | 500.00",
        "batch_place | 2 | 0.375 | 187.50"]
    assert timers[0].stats()["train_step"] == {
        "calls": 2, "total_s": 1.0, "mean_ms": 500.0, "median_ms": 500.0}
    timers[0].reset()
    assert timers[0].summary() == "section | calls | total_s | mean_ms"


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)


class _NanBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def test_debug_nan_raises_at_a_nan_backward():
    x = torch.ones(3, requires_grad=True)
    _NanBackward.apply(x).sum().backward()  # off: the NaN passes
    assert torch.isnan(x.grad).all()
    prof = tcommon.TrainProfiler("unused", debug_nan=True)
    try:
        assert torch.is_anomaly_enabled() and \
            torch.is_anomaly_check_nan_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            _NanBackward.apply(torch.ones(3, requires_grad=True)).sum(
            ).backward()
    finally:
        prof.finish()
    assert not torch.is_anomaly_enabled()


def test_profiler_flags_are_the_jax_packages():
    parsers = []
    for add in (tcommon.add_profiler_args, jcommon.add_profiler_args):
        parser = ArgumentParser()
        add(parser)
        parsers.append({a.dest: (a.default, a.choices, type(a).__name__)
                        for a in parser._actions if a.dest != "help"})
    assert parsers[0] == parsers[1]


def test_trainer_main_prints_both_sections(tmp_path, capsys):
    _, summary = train_diffusion_smpl.main([
        "--device", "cpu", "--synthetic", "2", "--batch_size", "2",
        "--embedding_dim", "32", "--ff_size", "64", "--num_layers", "2",
        "--synthetic_points", "64", "--val_respacing", "2", "--profiler",
        "simple", "--results_dir", str(tmp_path)])
    assert summary["steps"] == 2
    lines = capsys.readouterr().out.splitlines()
    head = lines.index("section | calls | total_s | mean_ms")
    rows = {ln.split(" | ")[0]: ln.split(" | ") for ln in lines[head + 1:
                                                                head + 3]}
    assert set(rows) == {"batch_place", "train_step"}
    assert rows["batch_place"][1] == rows["train_step"][1] == "2"


def test_correction_trainer_main_writes_a_trace(tmp_path, capsys):
    _, summary = train_correction_skeleton.main([
        "--device", "cpu", "--synthetic", "1", "--batch_size", "2",
        "--profiler", "trace", "--results_dir", str(tmp_path)])
    assert summary["steps"] == 1
    assert os.path.isfile(tmp_path / "trace" / "trace.json")
    assert "profiler trace written to" in capsys.readouterr().out
