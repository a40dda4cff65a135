"""aten operators the host dispatches in a plain DDPM step: the program's
counter ``sampler.ops`` (the second step of each sampler call, t = T-2,
where no hook fires, counted by a dispatch mode) over the steps counted."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    if not s or not s.calls.get("sampler.ops"):
        return None
    return s.counters["sampler.ops"] / s.calls["sampler.ops"]
