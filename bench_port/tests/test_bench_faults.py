"""Each fault an eval cell can have, planted under the timed path of a
small run driven through the harness (without its look for a chip): the
run must come out not correct.  And, on the chip, the control at the
cell's widths must fail the cell's limits while the program keeps to
them."""

import pytest
import torch

from bench_port import harness
from bench_port.tests import small


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _state_unchanged(monkeypatch, name):
    from interdiff_torch.diffusion.gaussian import GaussianDiffusion

    step = GaussianDiffusion.p_sample

    def unchanged(self, model_fn, x, t, **kw):
        out = step(self, model_fn, x, t, **kw)
        return {**out, "sample": x}

    monkeypatch.setattr(GaussianDiffusion, "p_sample", unchanged)


def _answer_altered(monkeypatch, name):
    from interdiff_torch.diffusion.gaussian import GaussianDiffusion

    loop = GaussianDiffusion.p_sample_loop

    def altered(self, *a, **kw):
        x = loop(self, *a, **kw)
        return torch.cat([x[:1] + 0.05, x[1:]])

    monkeypatch.setattr(GaussianDiffusion, "p_sample_loop", altered)


def _half_the_batch(monkeypatch, name):
    """The metrics of the first half of the clips, their mean standing for
    the whole batch's."""
    if name.startswith("smpl"):
        from interdiff_torch.cli import eval_smpl_short as entry

        best = entry.best_of_n_metrics

        def half(m, n):
            out = best(m, n)
            return {k: v[: len(v) // 2].repeat(2) for k, v in out.items()}

        monkeypatch.setattr(entry, "best_of_n_metrics", half)
    else:
        from interdiff_torch.cli import eval_skeleton as entry

        metrics = entry.skeleton_metrics

        def half(*args, start):
            return metrics(*(a[: len(a) // 2] for a in args), start=start)

        monkeypatch.setattr(entry, "skeleton_metrics", half)


FAULTS = {"state_unchanged": _state_unchanged,
          "answer_altered": _answer_altered,
          "half_the_batch": _half_the_batch}


CASES = [(n, f) for n in small.EVAL_CELLS for f in sorted(FAULTS)]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(monkeypatch, name, fault):
    wl, cfg = small.cell(name, clips=4)
    FAULTS[fault](monkeypatch, name)
    result, compared = small.run_module().measure(
        wl, cfg, 2 ** 33 + 5, 0.1, False, "cpu")
    assert not result["correct"], compared
    assert result["failed"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("name", small.EVAL_CELLS)
def test_the_control_fails_the_limits(cuda_device, name):
    """At the configuration's widths (1000 steps of 4 clips): the program
    within every limit, the control (the reference in TF32 in its place)
    beyond one of them."""
    import time

    wl = harness.workload(name)
    cfg = harness.config(wl["config"])
    wl["traffic_params"] = {**wl["traffic_params"], "clips": 4}
    out = harness.load_module("drivers", wl["driver"]).run(
        cfg, wl, 2 ** 32 + 3, 0.1, False, cuda_device, time.perf_counter(),
        control=True)
    assert out["correct"], out["compared"]
    assert any(out["control"][k] > wl["limits"][k] for k in wl["limits"]), \
        out["control"]
