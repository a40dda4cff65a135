"""Milliseconds of Python's collector a batch: the wall time of the
program's ``host.gc`` spans in the window's session over its
``eval.batch`` spans."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    batches = sum(p.name == "eval.batch" for p in s.spans) if s else 0
    if not batches:
        return None
    ns = sum(p.end_ns - p.start_ns for p in s.spans if p.name == "host.gc")
    return 1e-6 * ns / batches
