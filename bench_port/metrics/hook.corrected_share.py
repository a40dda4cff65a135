"""Percent of the rows the SMPL hook's projector ran on that the gate
kept corrected: the program's counters ``hook.rows_corrected`` over
``hook.rows``, summed over the window's firings."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    if not s or not s.counters.get("hook.rows"):
        return None
    return 100.0 * s.counters["hook.rows_corrected"] / s.counters["hook.rows"]
