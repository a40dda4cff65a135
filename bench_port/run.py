"""The benchmark of `interdiff_torch` on one H100.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell (`BENCHMARK.json` and `workloads/<cell>.json`), its
configuration (`configs/<config>.json`) and its driver
(`drivers/<driver>.py`), sets up, measures for ``--seconds`` in whole
units, holds what the window produced against the plain reference and
prints one JSON line: the end-to-end metrics, or with ``--trace 1`` the
per-layer metrics (`metrics/<metric>.py`), the device, the numbers
compared beside their limits.  Without a CUDA device it prints no result
and exits with 2."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_port import harness  # noqa: E402


def measure(wl: dict, cfg: dict, seed: int, seconds: float, trace: bool,
            device: str):
    """One run of the cell on ``device``: (the result line's fields, the
    numbers compared beside their limits)."""
    out = harness.load_module("drivers", wl["driver"]).run(
        cfg, wl, seed, seconds, trace, device, T0)
    metrics = {}
    for m in harness.metric_entries(wl["name"], trace):
        if trace:
            value = harness.load_module("metrics", m["name"]).read(
                out["record"])
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": out["device"]}
    if trace:
        result["breakdown"] = out["breakdown"]
    return result, out["compared"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.set_caches()
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"needs {wl['chips']} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result, compared = measure(wl, cfg, args.seed, args.seconds,
                               bool(args.trace), "cuda")
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    harness.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
