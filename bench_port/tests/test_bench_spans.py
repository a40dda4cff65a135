"""A traced run of each eval cell, cut small, on the CPU: the readers of
the program's spans and counters that need no CUDA device give finite
numbers in the result line, and those of device intervals give none."""

import math

import pytest
import torch

from bench_port.tests import small

HOST = {"smpl_eval_ddpm1000": ("sampler.ops_per_step", "sampler.offcpu_share",
                               "hook.corrected_share", "eval.gc_ms"),
        "skeleton_eval_ddpm1000": ("sampler.ops_per_step",
                                   "sampler.offcpu_share", "eval.gc_ms")}
DEVICE = ("sampler.denoise_ms", "sampler.posterior_ms", "hook.gate_ms")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", small.EVAL_CELLS)
def test_a_traced_run_reads_the_spans(name):
    wl, cfg = small.cell(name)
    result, _ = small.run_module().measure(wl, cfg, 2 ** 33 + 11, 0.1, True,
                                           "cpu")
    assert result["correct"]
    metrics = result["metrics"]
    for m in HOST[name]:
        assert math.isfinite(metrics[m]["value"]), m
    assert metrics["sampler.ops_per_step"]["value"] > 100
    assert 0.0 <= metrics["sampler.offcpu_share"]["value"] <= 100.0
    assert not set(DEVICE) & set(metrics)  # no CUDA events on the CPU
