"""Milliseconds of the SMPL hook's gate a firing: the mean device interval
of the program's ``hook.gate`` spans (FK, normals, K2, K4 and the gate's
arithmetic, up to the decision of which rows to correct)."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    ms = [p.device_ms for p in s.spans if p.name == "hook.gate"
          and p.device_ms is not None] if s else []
    return sum(ms) / len(ms) if ms else None
