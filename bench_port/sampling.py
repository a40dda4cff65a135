"""What both eval drivers share: the checked steps, the recorder that
wraps a denoiser's ``denoise`` for the window, the batches drawn until the
window's time is up, and the per-batch means read back from ``report``."""

from __future__ import annotations

import time

import numpy as np

from bench_port import harness
from bench_port.reference.diffusion import fires


def checked_steps(cfg: dict, seed: int) -> set:
    """Every firing of the hook and ``checked_steps`` other steps, drawn
    from the seed."""
    T = cfg["diffusion_steps"]
    fire = {t for t in range(T) if fires(cfg, t)}
    rest = np.array(sorted(set(range(1, T)) - fire))
    pick = harness.rng(seed, 5).choice(rest, cfg["checked_steps"],
                                       replace=False)
    return fire | {int(t) for t in pick}


class Recorder:
    """Counts the denoiser's calls (``steps`` a sampler call) and keeps, for
    each call, the states at the checked steps S: ``steps[unit][t] =
    [x_t, x0, x_{t-1}]`` (references to the loop's own tensors: the loop
    makes a new one every step).  ``finish(out)`` stores a call's sample
    as the x_{t-1} of t = 0.
    With a ``Profiled``, the call ``profile_unit`` is profiled over its
    first two steps and its last ``profiled_steps``."""

    def __init__(self, denoise, steps: int, S: set, prof=None,
                 profiled_steps: int = 0):
        self.denoise, self.T, self.S = denoise, steps, S
        self.prof, self.profiled_steps = prof, profiled_steps
        self.calls = 0
        self.profile_unit = None
        self.steps = {}

    def __call__(self, x, *args, **kwargs):
        unit, n = divmod(self.calls, self.T)
        self.calls += 1
        t = self.T - 1 - n
        if self.prof is not None and unit == self.profile_unit:
            if n == 2 and self.prof.active:
                self.prof.stop()
            if n == self.T - self.profiled_steps:
                self.prof.start()
        out = self.denoise(x, *args, **kwargs)
        at = self.steps.setdefault(unit, {})
        if t in self.S:
            at.setdefault(t, [None, None, None])[:2] = [x, out]
        if t + 1 in self.S:
            at.setdefault(t + 1, [None, None, None])[2] = x
        return out

    def finish(self, out, unit: int = None):
        """Store the sample of ``unit`` (by default the call just ended):
        x_{-1} of its last step, t = 0, always checked (it fires)."""
        if unit is None:
            unit = self.calls // self.T - 1
        self.steps[unit][0][2] = out

    def record(self, unit: int, means: dict) -> dict:
        return {"steps": {t: tuple(v) for t, v in self.steps[unit].items()},
                "means": means}


def window_batches(make, seconds: float, t_start: float):
    """Batches ``make(b)`` until ``seconds`` have passed since ``t_start``
    (checked when the entry point asks for the next one, after a batch's
    report has read the device); at least one."""
    b = 0
    while b == 0 or time.perf_counter() - t_start < seconds:
        yield make(b)
        b += 1


class Means:
    """``report(nb, running means)`` -> each batch's own means."""

    def __init__(self):
        self.totals = []

    def __call__(self, nb, running):
        self.totals.append({k: v * nb for k, v in running.items()})

    def batch(self, b: int) -> dict:
        prev = self.totals[b - 1] if b else {}
        return {k: v - prev.get(k, 0.0) for k, v in self.totals[b].items()}


def check_window(nb: int, batch_of, step_noise_of, rec: Recorder,
                 means: Means, check, control_record, limits: dict,
                 rows: int, control: bool = False) -> dict:
    """Hold every batch of the window against the reference: ``check(
    batch, record, noise_at) -> gaps`` and, with ``control``, the same
    check of ``control_record(batch, record, noise_at)``.  Returns the
    result's ``correct``, ``failed`` (the rows of failing batches) and
    ``compared`` (each gap's largest value beside its limit), and with
    ``control`` the control's largest gaps."""
    gaps = {k: 0.0 for k in limits}
    control_gaps = dict(gaps)
    failed = 0
    for b in range(nb):
        batch = batch_of(b)
        step_noise = step_noise_of(b)

        def noise_at(t):
            return step_noise[rec.T - 1 - t]

        record = rec.record(b, means.batch(b))
        g = check(batch, record, noise_at)
        if control:
            c = check(batch, control_record(batch, record, noise_at),
                      noise_at)
            control_gaps = {k: max(control_gaps[k], c[k])
                            for k in control_gaps}
        failed += any(g[k] > limits[k] for k in g) * rows
        gaps = {k: max(gaps[k], g[k]) for k in gaps}
    out = {"failed": failed, "correct": failed == 0 and nb > 0,
           "compared": {k: {"value": gaps[k], "limit": limits[k]}
                        for k in gaps}}
    if control:
        out["control"] = control_gaps
    return out
