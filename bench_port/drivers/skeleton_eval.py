"""The skeleton eval entry point, `interdiff_torch.cli.eval_skeleton.
evaluate`, with the skeleton projector in the loop and the DDPM of the
cell's configuration, no rollouts.

As `smpl_eval.py`: set-up builds the seeded denoiser and projector and
warms every shape up with a two-step schedule; the window is one
`evaluate` over batches drawn from the seed until ``seconds`` have passed;
the denoiser's states at the checked steps and each batch's forecast are
kept; a traced run passes ``timings`` and the hook's ``trace`` and profiles
one more batch; then the reference holds every batch of the window against
the program (`reference/skeleton_eval.py`).  This path launches none of
the port's hand-written kernels."""

from __future__ import annotations

import functools
import time

import torch

from bench_port import flops, harness, sampling, traffic, weights
from bench_port.reference import skeleton_eval as ref


def run(cfg: dict, wl: dict, seed: int, seconds: float, trace: bool,
        device: str, t0: float, control: bool = False) -> dict:
    """One run; with ``control`` the control's gaps too (``out["control"]``:
    the reference in TF32 in the program's place, read by
    `tools/readings.py`, never by a benchmark run)."""
    from interdiff_torch.cli import eval_skeleton as entry
    from interdiff_torch.config import (
        CorrectionConfig,
        DiffusionConfig,
        SkeletonTrackConfig,
    )
    from interdiff_torch.eval.skeleton import SkeletonEvalConfig

    tr = {**wl["traffic_params"], "past_len": cfg["past_len"],
          "future_len": cfg["future_len"], "joints": cfg["num_joints"],
          "keypoints": cfg["num_points"]}
    model = SkeletonTrackConfig(
        **harness.config_args(cfg, SkeletonTrackConfig)).build_model(device)
    sd = weights.seeded_state(model, harness.torch_seed(seed, 2))
    model.load_state_dict(sd, strict=True)
    projector = CorrectionConfig(
        track="skeleton", num_nodes=cfg["num_joints"], dct=cfg["dct"],
        past_len=cfg["past_len"], future_len=cfg["future_len"]
    ).build_model(device)
    psd = weights.seeded_state(projector, harness.torch_seed(seed, 3))
    projector.load_state_dict(psd, strict=True)
    steps = cfg["diffusion_steps"]
    diffusion = DiffusionConfig(
        **harness.config_args(cfg, DiffusionConfig)).build(device)
    ecfg = SkeletonEvalConfig(
        past_len=cfg["past_len"], future_len=cfg["future_len"],
        num_joints=cfg["num_joints"], num_points=cfg["num_points"],
        correction_t_max=cfg["correction_t_max"],
        correction_every=cfg["correction_every"])
    rows, frames = tr["clips"], cfg["past_len"] + cfg["future_len"]
    shape = (rows, frames, 3 * (cfg["num_joints"] + cfg["num_points"]) + 7)
    S = sampling.checked_steps(cfg, seed)

    def clips(b):
        return traffic.skeleton_clips(harness.rng(seed, 20, b), tr)

    def noises(first, n=steps):
        b = first
        while True:
            yield traffic.sampling_noise(
                harness.torch_seed(seed, 10, b), shape, n, device)
            b += 1

    # -- warm-up: every shape of the window, through a two-step schedule
    cuda = device != "cpu"
    short = DiffusionConfig(**{**harness.config_args(cfg, DiffusionConfig),
                               "timestep_respacing": "2"}).build(device)
    entry.evaluate(ecfg, model, short, [clips(-1)], projector=projector,
                   noises=noises(-1, 2), report=lambda nb, m: None)
    traffic.sampling_noise(0, shape, steps, device)  # the window's size
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    prof = harness.Profiled() if trace else None
    denoise = model.denoise
    rec = sampling.Recorder(denoise, steps, S, prof, cfg["profiled_steps"])
    hook_trace = [] if trace else None
    timings = {} if trace else None
    means = sampling.Means()
    forecasts = []
    model.denoise = rec
    try:
        t_start = time.perf_counter()
        _, nb = entry.evaluate(
            ecfg, model, diffusion,
            sampling.window_batches(clips, seconds, t_start),
            projector=projector, noises=noises(0), report=means,
            timings=timings, trace=hook_trace, forecasts=forecasts)
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t_start
        if trace:
            rec.profile_unit = nb
            prof.start()
            entry.evaluate(ecfg, model, diffusion, [clips(nb)],
                           projector=projector, noises=noises(nb),
                           report=lambda n, m: None)
            prof.stop()
    finally:
        model.denoise = denoise
    out = {"attempted": nb * rows, "e2e": {
        "setup_s": t_start - t0, "sample_seq_per_s": nb * rows / window}}
    for b, f in enumerate(forecasts):
        rec.finish(torch.cat([f["body"].flatten(2), f["obj"].flatten(2),
                              f["pose"]], -1), b)
    summary = prof.summary() if trace else None
    out["device"] = harness.device_info(summary) if cuda else {}
    if trace:
        out["breakdown"] = {k: summary[k] for k in ("device_ops",
                                                    "idle_gaps")}
        out["record"] = {
            "cell": wl["name"], "cfg": cfg, "traffic": tr,
            "window_s": window, "batches": nb, "timings": timings,
            "sampler_steps": nb * steps,
            "flops": nb * (flops.skeleton_encode(cfg, rows)
                           + steps * flops.skeleton_denoise(cfg, rows,
                                                            frames)),
            "firing_ms": [e["start"].elapsed_time(e["end"])
                          for e in hook_trace if "start" in e],
            "profile": summary}
    del model, projector, diffusion, short
    if cuda:
        torch.cuda.empty_cache()

    out.update(sampling.check_window(
        nb, lambda b: {k: torch.as_tensor(v, device=device)
                       for k, v in clips(b).items()},
        lambda b: next(noises(b))[1], rec, means,
        functools.partial(ref.check_batch, cfg, sd, psd),
        functools.partial(ref.control_record, cfg, sd, psd),
        wl["limits"], rows, control))
    return out
