"""The text-to-motion entry point, `interdiff_torch.cli.eval_text.evaluate`:
MDM with CLIP's text tower, classifier-free guidance at the
configuration's scale, the configuration's DDPM and HumanML3D's
`recover_from_ric`.

Set-up builds the seeded model (tower included) and warms every shape up
with a two-step schedule.  The window is one `evaluate` over batches of
captions drawn from the seed until ``seconds`` have passed; it ends at the
end of a whole batch.  While it runs, the denoiser's inputs and outputs at
the checked steps (drawn from the seed, t = 0 always: no hook fires here),
each batch's pooled text, sample and joints are kept (references, no
copies).  A traced run passes ``timings`` and, after the window, profiles
one more batch: its encode, its first two and its last steps and the
post-processing.  Then the reference holds every batch of the window
against the program (`reference/mdm_text.py`)."""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from bench_port import flops_text, harness, sampling, traffic, weights
from bench_port.reference import mdm_text as ref


def captions(rng: np.random.Generator, tr: dict, cfg: dict) -> np.ndarray:
    """ids [captions, context]: SOT, ``tokens`` (low, high) ids drawn
    uniformly from [1, vocabulary - 3], EOT, zeros; SOT and EOT are the
    vocabulary's last two ids."""
    V, B = cfg["vocab_size"], tr["captions"]
    lo, hi = tr["tokens"]
    n = rng.integers(lo, hi + 1, B)
    ids = np.zeros((B, cfg["context_length"]), dtype=np.int64)
    for i in range(B):
        ids[i, 0] = V - 2
        ids[i, 1:n[i] + 1] = rng.integers(1, V - 2, n[i])
        ids[i, n[i] + 1] = V - 1
    return ids


def checked_steps(cfg: dict, seed: int) -> set:
    """t = 0 (the sample) and ``checked_steps`` other steps, drawn from the
    seed."""
    pick = harness.rng(seed, 5).choice(np.arange(1, cfg["diffusion_steps"]),
                                       cfg["checked_steps"], replace=False)
    return {0} | {int(t) for t in pick}


def run(cfg: dict, wl: dict, seed: int, seconds: float, trace: bool,
        device: str, t0: float, control: bool = False) -> dict:
    """One run; with ``control`` the control's gaps too (``out["control"]``:
    the reference in TF32 in the program's place, read by
    `tools/readings.py`, never by a benchmark run)."""
    from interdiff_torch.cli import eval_text as entry
    from interdiff_torch.config import DiffusionConfig, TextTrackConfig
    from interdiff_torch.eval.text import TextEvalConfig

    tr = wl["traffic_params"]
    model = TextTrackConfig(
        **harness.config_args(cfg, TextTrackConfig)).build_model(device)
    sd = weights.seeded_state(model, harness.torch_seed(seed, 2))
    model.load_state_dict(sd, strict=True)
    steps = cfg["diffusion_steps"]
    diffusion = DiffusionConfig(
        **harness.config_args(cfg, DiffusionConfig)).build(device)
    ecfg = TextEvalConfig(num_frames=cfg["num_frames"],
                          num_joints=cfg["num_joints"],
                          guidance_param=cfg["guidance_param"])
    rows = tr["captions"]
    shape = (rows, cfg["num_frames"], cfg["njoints"])
    S = checked_steps(cfg, seed)

    def batch(b):
        return {"ids": captions(harness.rng(seed, 20, b), tr, cfg)}

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
    entry.evaluate(ecfg, model, short, [batch(-1)], noises=noises(-1, 2),
                   report=lambda nb, m: None)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    prof = harness.Profiled() if trace else None
    denoise, encode_text = model.denoise, model.encode_text
    rec = sampling.Recorder(denoise, steps, S, prof, cfg["profiled_steps"])
    texts = []

    def keep_text(ids):
        texts.append(encode_text(ids))
        return texts[-1]

    timings = {} if trace else None
    means = sampling.Means()
    motions = []
    model.denoise, model.encode_text = rec, keep_text
    try:
        t_start = time.perf_counter()
        _, nb = entry.evaluate(
            ecfg, model, diffusion,
            sampling.window_batches(batch, seconds, t_start),
            noises=noises(0), report=means, timings=timings, motions=motions)
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t_start
        if trace:
            rec.profile_unit = nb
            prof.start()
            entry.evaluate(ecfg, model, diffusion, [batch(nb)],
                           noises=noises(nb), report=lambda n, m: None)
            prof.stop()
    finally:
        model.denoise, model.encode_text = denoise, encode_text
    out = {"attempted": nb * rows, "e2e": {
        "setup_s": t_start - t0, "sample_seq_per_s": nb * rows / window}}
    for b, m in enumerate(motions):
        rec.finish(m["sample"], b)
    summary = prof.summary() if trace else None
    out["device"] = harness.device_info(summary) if cuda else {}
    if trace:
        out["breakdown"] = {k: summary[k] for k in ("device_ops",
                                                    "idle_gaps")}
        out["record"] = {
            "cell": wl["name"], "cfg": cfg, "traffic": tr,
            "window_s": window, "batches": nb, "timings": timings,
            "sampler_steps": nb * steps,
            "flops": nb * flops_text.batch(cfg, rows, steps),
            "profile": summary}
    del model, diffusion, short
    if cuda:
        torch.cuda.empty_cache()

    out.update(sampling.check_window(
        nb, lambda b: {"ids": torch.as_tensor(batch(b)["ids"],
                                              device=device),
                       "text": texts[b], "joints": motions[b]["joints"]},
        lambda b: next(noises(b))[1], rec, means,
        functools.partial(ref.check_batch, cfg, sd),
        functools.partial(ref.control_record, cfg, sd),
        wl["limits"], rows, control))
    return out
