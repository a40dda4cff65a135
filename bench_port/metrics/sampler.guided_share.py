"""Percent of the denoiser's calls that ran classifier-free guidance (both
halves in one call): the program's counters ``guidance.calls`` over
``denoise.calls`` in the traced window's session."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    if not s or not s.counters.get("denoise.calls") \
            or "guidance.calls" not in s.counters:
        return None
    return 100.0 * s.counters["guidance.calls"] / s.counters["denoise.calls"]
