"""Percent of the positions the text tower runs that hold a caption (SOT
to EOT): the program's counters ``text.live_tokens`` over
``text.tokens``; the rest is padding behind the causal mask."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    if not s or not s.counters.get("text.tokens"):
        return None
    return 100.0 * s.counters.get("text.live_tokens", 0) \
        / s.counters["text.tokens"]
