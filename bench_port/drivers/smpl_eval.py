"""The SMPL eval entry point, `interdiff_torch.cli.eval_smpl_short.
evaluate`, with the projector in the loop and the DDPM of the cell's
configuration.

Set-up builds the stand-in body, the seeded denoiser (biased to the rest
pose) and projector, and warms every shape up with one call of a two-step
schedule.  The window is one `evaluate` over batches drawn from the seed
until ``seconds`` have passed; it ends at the end of a whole batch.  While
it runs, the denoiser's inputs and outputs at the checked steps and each
call's sample are kept (references, no copies), and the per-batch metric
means come from ``report``.  A traced run passes ``timings`` and the
hook's ``trace`` and, after the window, profiles one more batch: its encode
and its last steps, which hold the last two firings, the post-processing
and the metrics.  Once the window has closed, the peak memory has been read
and the program's modules are freed, the reference holds every batch of
the window against the program (`reference/smpl_eval.py`)."""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from bench_port import body as bodymod
from bench_port import flops, harness, sampling, traffic, weights
from bench_port.reference import smpl_eval as ref


def run(cfg: dict, wl: dict, seed: int, seconds: float, trace: bool,
        device: str, t0: float, control: bool = False) -> dict:
    """One run; with ``control`` the control's gaps too (``out["control"]``:
    the reference in TF32 in the program's place, read by
    `tools/readings.py`, never by a benchmark run)."""
    from interdiff_torch.cli import eval_smpl_short as entry
    from interdiff_torch.config import (
        CorrectionConfig,
        DiffusionConfig,
        SmplTrackConfig,
        build_smpl_body,
    )
    from interdiff_torch.eval import smpl_short
    from interdiff_torch.eval.smpl_short import SmplEvalConfig

    tr = {**wl["traffic_params"], "past_len": cfg["past_len"],
          "future_len": cfg["future_len"]}
    arrays = bodymod.stand_in_arrays(harness.rng(seed, 1),
                                     cfg["body"]["num_verts"],
                                     cfg["body"]["num_joints"])
    smpl = build_smpl_body(arrays, device=device)
    model = SmplTrackConfig(
        **harness.config_args(cfg, SmplTrackConfig)).build_model(device)
    sd = weights.seeded_state(model, harness.torch_seed(seed, 2))
    weights.rest_pose(sd, cfg["smpl_dim"], cfg["rest_pose_object"])
    model.load_state_dict(sd, strict=True)
    projector = CorrectionConfig(
        num_nodes=len(cfg["markers"]), dct=cfg["dct"],
        past_len=cfg["past_len"], future_len=cfg["future_len"]
    ).build_model(device)
    psd = weights.seeded_state(projector, harness.torch_seed(seed, 3))
    projector.load_state_dict(psd, strict=True)
    steps = cfg["diffusion_steps"]
    diffusion = DiffusionConfig(
        **harness.config_args(cfg, DiffusionConfig)).build(device)
    ecfg = SmplEvalConfig(
        past_len=cfg["past_len"], future_len=cfg["future_len"],
        correction_t_max=cfg["correction_t_max"],
        correction_every=cfg["correction_every"],
        nn_prune_delta=cfg["nn_prune_delta"])
    markers = np.minimum(np.asarray(cfg["markers"]), smpl.num_verts - 1)
    rows = tr["clips"] * cfg["diverse_fold"]
    shape = (rows, cfg["past_len"] + cfg["future_len"], cfg["smpl_dim"] + 12)
    S = sampling.checked_steps(cfg, seed)
    kw = dict(projector=projector, diverse_samples=cfg["diverse_samples"],
              diverse_fold=cfg["diverse_fold"], sampler="ddpm",
              markers_idx=markers)
    if cfg["diverse_samples"] != cfg["diverse_fold"]:
        raise ValueError("the check reads one sampler call a batch: "
                         "diverse_samples must equal diverse_fold")

    def clips(b):
        return traffic.smpl_clips(harness.rng(seed, 20, b), tr)

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
    entry.evaluate(ecfg, model, short, smpl, [clips(-1)],
                   noises=noises(-1, 2), report=lambda nb, m: None, **kw)
    traffic.sampling_noise(0, shape, steps, device)  # the window's size
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # -- what the window keeps: states at the checked steps, samples, means
    prof = harness.Profiled() if trace else None
    rec = sampling.Recorder(model.denoise, steps, S, prof,
                            cfg["profiled_steps"])
    k2_inputs = []
    denoise = model.denoise
    build = entry.make_sampler
    hook_trace = [] if trace else None

    def recording_build(*args, **kwargs):
        sample = build(*args, trace=hook_trace, **kwargs)

        def run_sample(*a, **k):
            out = sample(*a, **k)
            rec.finish(out)
            return out

        return run_sample

    pruned = smpl_short.signed_nearest_pruned

    def recording_pruned(a, b, n, **kwargs):
        if prof is not None and prof.active:
            k2_inputs.append((a, b))
        return pruned(a, b, n, **kwargs)

    timings = {} if trace else None
    means = sampling.Means()
    model.denoise = rec
    entry.make_sampler = recording_build
    smpl_short.signed_nearest_pruned = recording_pruned
    try:
        t_start = time.perf_counter()
        _, nb = entry.evaluate(
            ecfg, model, diffusion, smpl,
            sampling.window_batches(clips, seconds, t_start),
            noises=noises(0), report=means, timings=timings, **kw)
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t_start
        if trace:
            # one more batch, profiled over its encode and its last steps
            rec.profile_unit = nb
            prof.start()
            entry.evaluate(ecfg, model, diffusion, smpl, [clips(nb)],
                           noises=noises(nb), report=lambda n, m: None,
                           **kw)
            prof.stop()
    finally:
        model.denoise = denoise
        entry.make_sampler = build
        smpl_short.signed_nearest_pruned = pruned
    out = {"attempted": nb * rows, "e2e": {
        "setup_s": t_start - t0, "sample_seq_per_s": nb * rows / window}}
    summary = prof.summary() if trace else None
    out["device"] = harness.device_info(summary) if cuda else {}
    if trace:
        out["breakdown"] = {k: summary[k] for k in ("device_ops",
                                                    "idle_gaps")}
        enc = flops.smpl_encode(cfg, tr["clips"], tr["points"])
        den = flops.smpl_denoise(cfg, rows, shape[1])
        out["record"] = {
            "cell": wl["name"], "cfg": cfg, "traffic": tr,
            "window_s": window, "batches": nb,
            "timings": timings, "sampler_steps": nb * steps,
            "flops": nb * (enc + steps * den),
            "firing_ms": [e["start"].elapsed_time(e["end"])
                          for e in hook_trace if "start" in e],
            "profile": summary,
            "kernels": prof.kernels(),
            "k2_pairs": [flops.k2_pairs(a, b, cfg["nn_prune_delta"])
                         for a, b in k2_inputs],
            "rows": rows, "frames": shape[1]}
    del model, projector, smpl, diffusion, short
    if cuda:
        torch.cuda.empty_cache()

    # -- the reference, batch by batch
    rbody = bodymod.reference_body(arrays, cfg["markers"], device)
    out.update(sampling.check_window(
        nb, lambda b: {k: torch.as_tensor(v, device=device)
                       for k, v in clips(b).items()},
        lambda b: next(noises(b))[1], rec, means,
        functools.partial(ref.check_batch, cfg, sd, psd, rbody),
        functools.partial(ref.control_record, cfg, sd, psd, rbody),
        wl["limits"], rows, control))
    return out
