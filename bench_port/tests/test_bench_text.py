"""The text-to-motion cell, `mdm_humanml_t2m_ddpm1000`, cut small on the
CPU: a run agrees with the reference, each planted fault reads not
correct, a traced run reads the text and guidance counters, and
`flops_text.py` matches a count by hand.  On the chip: TF32 in the program
reads not correct, and at the configuration's widths the program keeps
to every limit while the control passes one of them."""

import math
import time

import pytest
import torch

from bench_port import flops, flops_text, harness
from bench_port.tests import small

CELL = "mdm_humanml_t2m_ddpm1000"
SMALL = {"latent_dim": 64, "ff_size": 128, "num_layers": 2, "num_heads": 2,
         "clip_dim": 64, "vocab_size": 100, "transformer_width": 64,
         "transformer_layers": 2, "transformer_heads": 2, "num_frames": 12,
         "diffusion_steps": 60, "checked_steps": 3, "profiled_steps": 10}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _cell(captions=3):
    wl = harness.workload(CELL)
    wl["traffic_params"] = {**wl["traffic_params"], "captions": captions}
    return wl, {**harness.config(wl["config"]), **SMALL}


def test_a_run_agrees_with_the_reference():
    wl, cfg = _cell()
    result, compared = small.run_module().measure(
        wl, cfg, 2 ** 31 + 7, 0.1, False, "cpu")
    assert result["correct"] and result["attempted"] > 0
    assert set(compared) == {"text_gap", "denoise_gap", "step_gap",
                             "joints_gap"}
    for k, c in compared.items():
        assert c["value"] <= c["limit"], (k, c)


def test_a_traced_run_reads_the_counters():
    wl, cfg = _cell()
    result, _ = small.run_module().measure(wl, cfg, 2 ** 33 + 11, 0.1, True,
                                           "cpu")
    assert result["correct"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["sampler.guided_share"] == 100.0
    # SOT, 6-20 ids and EOT of 77 positions
    assert 8 / 77 * 100 <= m["text.live_share"] <= 22 / 77 * 100
    assert math.isfinite(m["sampler.ops_per_step"])
    assert "text.encode_ms" not in m  # no CUDA events on the CPU


def _scale_one(monkeypatch):
    from interdiff_torch.models.mdm_text import MDMText

    denoise = MDMText.denoise

    def one(self, x, ts, text, scale=None, **kw):
        return denoise(self, x, ts, text, torch.ones_like(scale), **kw)

    monkeypatch.setattr(MDMText, "denoise", one)


def _null_without_bias(monkeypatch):
    """L_text's output zeroed on the null rows (a zero condition)."""
    from interdiff_torch.config import TextTrackConfig

    build = TextTrackConfig.build_model

    def hooked(self, device=None):
        model = build(self, device)
        model.embed_text.register_forward_hook(
            lambda m, inp, out: torch.where(
                (inp[0] == 0).all(-1, keepdim=True), 0.0, out))
        return model

    monkeypatch.setattr(TextTrackConfig, "build_model", hooked)


def _pool_last(monkeypatch):
    from interdiff_torch.models.clip_text import CLIPTextEncoder

    monkeypatch.setattr(CLIPTextEncoder, "forward", lambda self, ids: (
        self.text_projection(self.hidden(ids)[:, -1])))


def _frame_off(monkeypatch):
    """The root's heading from the rotational velocities up to and
    including its own frame."""
    from interdiff_torch.cli import eval_text

    recover = eval_text.recover_from_ric

    def off(data, joints_num):
        shifted = data.clone()
        shifted[..., :-1, 0] = data[..., 1:, 0]
        return recover(shifted, joints_num)

    monkeypatch.setattr(eval_text, "recover_from_ric", off)


FAULTS = {"scale_one": _scale_one, "null_without_bias": _null_without_bias,
          "pool_last": _pool_last, "frame_off": _frame_off}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    wl, cfg = _cell()
    FAULTS[fault](monkeypatch)
    result, compared = small.run_module().measure(
        wl, cfg, 2 ** 33 + 5, 0.1, False, "cpu")
    assert not result["correct"], compared
    assert result["failed"] > 0


def test_flops_by_hand():
    cfg = {"context_length": 3, "transformer_width": 4,
           "transformer_layers": 2, "clip_dim": 5, "num_frames": 2,
           "latent_dim": 4, "njoints": 3, "num_layers": 1, "ff_size": 8}
    B = 1
    # tower: per layer q, k, v and out projections of 3 positions, scores
    # and weighted sums of 3 x 3 pairs, the MLP 4 -> 16 -> 4; the EOT row's
    # projection 4 -> 5
    layer = (2 * 3 * 4 * 4 * 4 + 2 * 2 * 3 * 3 * 4 + 2 * 3 * 4 * 16 * 2)
    assert flops_text.tower(cfg, B) == 2 * layer + 2 * 4 * 5
    # denoiser: 2 rows of timestep MLP (2 x 4x4) and text (5 -> 4), 2 x 2
    # frames in (3 -> 4) and out (4 -> 3), one layer over 3 tokens
    R, T = 2, 3
    enc = (2 * R * T * 4 * 4 * 4 + 2 * 2 * R * T * T * 4
           + 2 * R * T * 4 * 8 * 2)
    assert flops_text.guided_denoise(cfg, B) == (
        2 * 2 * R * 4 * 4 + 2 * R * 5 * 4 + 2 * (2 * R * 2 * 3 * 4)
        + enc)
    assert flops_text.batch(cfg, B, 10) == flops_text.tower(cfg, B) \
        + 10 * flops_text.guided_denoise(cfg, B)
    assert flops.mha(R, T, T, 4) == 2 * R * T * 4 * 4 * 4 \
        + 2 * 2 * R * T * T * 4


@pytest.mark.chip
def test_tf32_in_the_program_is_not_correct(cuda_device, monkeypatch):
    from interdiff_torch.models.mdm_text import MDMText

    denoise = MDMText.denoise

    def tf32(self, *a, **kw):
        torch.backends.cuda.matmul.allow_tf32 = True
        return denoise(self, *a, **kw)

    monkeypatch.setattr(MDMText, "denoise", tf32)
    wl = harness.workload(CELL)
    cfg = harness.config(wl["config"])
    wl["traffic_params"] = {**wl["traffic_params"], "captions": 4}
    try:
        out = harness.load_module("drivers", wl["driver"]).run(
            cfg, wl, 2 ** 32 + 17, 0.1, False, cuda_device,
            time.perf_counter())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert not out["correct"], out["compared"]


@pytest.mark.chip
def test_the_control_fails_a_limit(cuda_device):
    """At the configuration's widths (1000 steps of 4 captions): the
    program within every limit, the control beyond one of them."""
    wl = harness.workload(CELL)
    cfg = harness.config(wl["config"])
    wl["traffic_params"] = {**wl["traffic_params"], "captions": 4}
    out = harness.load_module("drivers", wl["driver"]).run(
        cfg, wl, 2 ** 32 + 3, 0.1, False, cuda_device, time.perf_counter(),
        control=True)
    assert out["correct"], out["compared"]
    assert any(out["control"][k] > wl["limits"][k] for k in wl["limits"]), \
        out["control"]
