"""Milliseconds a firing of the correction hook: the CUDA events of the
hook's own trace, summed over firings and divided by their number."""


def read(rec):
    f = rec.get("firing_ms")
    if not f:
        return None
    return sum(f) / len(f)
