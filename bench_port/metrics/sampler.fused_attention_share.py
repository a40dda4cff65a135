"""Percent of MDM's encoder layers whose self-attention ran as the packed
QKV product and kernel K7: the program's counters
``attention.fused_layers`` over ``attention.layers`` in the traced
window's session (none where the program does not count them)."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    if not s or not s.counters.get("attention.layers"):
        return None
    return 100.0 * s.counters.get("attention.fused_layers", 0) \
        / s.counters["attention.layers"]
