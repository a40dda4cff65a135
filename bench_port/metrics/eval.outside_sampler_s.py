"""Seconds a batch outside the sampler: encode, post-processing FK and the
metrics (K3), from the entry point's synchronised ``timings``."""


def read(rec):
    t = rec.get("timings")
    if not t or "sampler" not in t or not rec["batches"]:
        return None
    return (sum(t.values()) - t["sampler"]) / rec["batches"]
