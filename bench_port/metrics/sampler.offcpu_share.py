"""Percent of the sampler's wall time in which the dispatching thread was
off the CPU: the sum over the program's ``eval.sampler`` spans (each a
sampler call: its DDPM steps and the call's set-up) of wall time less the
thread's CPU time, over the sum of their wall time.  The per-step spans
carry no CPU time: a system call in the step loop costs a few tenths of
a millisecond on the benchmark's host."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    calls = [p for p in s.spans if p.name == "eval.sampler"
             and p.cpu_start_ns is not None] if s else []
    wall = sum(p.end_ns - p.start_ns for p in calls)
    if not wall:
        return None
    cpu = sum(p.cpu_end_ns - p.cpu_start_ns for p in calls)
    return 100.0 * (wall - cpu) / wall
