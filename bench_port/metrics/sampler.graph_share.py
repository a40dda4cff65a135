"""Percent of the denoiser's calls served by a replay of a CUDA graph:
the program's counters ``denoise.replays`` over ``denoise.calls`` in the
traced window's session (none where the program does not count them)."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    if not s or not s.counters.get("denoise.calls"):
        return None
    return 100.0 * s.counters.get("denoise.replays", 0) \
        / s.counters["denoise.calls"]
