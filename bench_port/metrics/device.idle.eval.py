"""Percent of the profiled slice of an eval batch (its encode, its last
steps with two firings, the post-processing and the metrics) in which no
operation ran on the device."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["window_s"] or not rec.get("batches"):
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
