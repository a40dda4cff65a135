"""Milliseconds of a DDPM step outside the denoiser and the hook: the
device interval of each ``sampler.step`` span less those of its
``sampler.denoise`` and ``hook.firing`` children (schedule gathers,
inpainting, the posterior mean and the noise), averaged over the steps."""

from interdiff_torch.utils import profiling

CHILDREN = ("sampler.denoise", "hook.firing")


def read(rec):
    last = getattr(profiling, "last_session", None)
    s = last() if last else None
    if not s:
        return None
    inner = {}
    for p in s.spans:
        if p.name in CHILDREN and p.parent is not None:
            if p.device_ms is None:
                return None
            inner[p.parent] = inner.get(p.parent, 0.0) + p.device_ms
    steps = [p.device_ms - inner.get(p.id, 0.0) for p in s.spans
             if p.name == "sampler.step" and p.device_ms is not None]
    return sum(steps) / len(steps) if steps else None
