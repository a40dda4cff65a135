"""Milliseconds of CLIP's text tower a batch: the mean device interval of
the program's ``text.encode`` spans over the traced window's session."""

from interdiff_torch.utils import profiling


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    ms = [p.device_ms for p in s.spans if p.name == "text.encode"
          and p.device_ms is not None] if s else []
    return sum(ms) / len(ms) if ms else None
