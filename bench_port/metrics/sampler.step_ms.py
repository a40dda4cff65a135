"""Milliseconds a DDPM step: the entry point's synchronised sampler time
over the steps it ran."""


def read(rec):
    t = rec.get("timings")
    if not t or "sampler" not in t or not rec["sampler_steps"]:
        return None
    return 1e3 * t["sampler"] / rec["sampler_steps"]
