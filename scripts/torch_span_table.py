"""The spans and counters of `interdiff_torch` on one cell of the
benchmark, read on one NVIDIA GPU: the operator's table of where an eval
batch's time goes.

    python3 scripts/torch_span_table.py --workload smpl_eval_ddpm1000 \\
        --seed 1234567891 [--seconds 51] [--pairs 1] [--out FILE]

From a checkout's root.  Runs the cell's driver (`bench_port/drivers/`)
untraced and then traced on the same seed, in one process, ``--pairs``
times (the seed one higher and the order swapped each pair), and prints
each run's window rate (`sample_seq_per_s`) and, per pair, the traced
rate over the untraced one: the cost of tracing when it is on.  Then the
table of the last traced window's session
(`interdiff_torch.utils.profiling.last_session()`): per span name the
count, host ms, device ms (between the span's CUDA events) and self ms
(host ms outside the span's child spans), totals over the window; a line
per batch with its wall, collector (``host.gc``) and off-CPU ms (wall less
the thread's CPU time); the counters; and the 10 longest idle gaps of the
device in the traced run's profiled slice, each put down to the innermost
program span whose `record_function` range covers its middle (the
benchmark's breakdown names the innermost host event of any kind).
``--out`` writes the same as one JSON object.  Exits 2 without a CUDA
device.

The other view of the spans is a profiler trace: `--profiler trace` of the
trainers or `utils/profiling.trace()` around any call writes a Chrome
trace in which every span is a `record_function` range of its name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.getcwd())  # the checkout to read
from bench_port import harness  # noqa: E402

SCOPES = ("eval.", "sampler.", "hook.")  # the program's span names


class KeptProfile(harness.Profiled):
    """The benchmark's profiled slice, its segments kept after the run."""

    last = None

    def __init__(self):
        super().__init__()
        KeptProfile.last = self


def gaps_by_span(segments, top: int = 10) -> list:
    """The ``top`` longest idle gaps between device operations (ms), each
    with the innermost program span over its middle."""
    gaps = []
    for seg in segments:
        end = None
        for _, s, e in seg["device"]:
            if end is not None and s > end:
                gaps.append((s - end, 0.5 * (s + end), seg))
            end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: -g[0])
    out = []
    for length, mid, seg in gaps[:top]:
        over = [h for h in seg["host"] if h[0].startswith(SCOPES)
                and h[1] <= mid <= h[2]]
        name = min(over, key=lambda h: h[2] - h[1])[0] if over else "none"
        out.append([name, 1e3 * length])
    return out


def run_once(wl: dict, cfg: dict, seed: int, seconds: float,
             trace: bool) -> dict:
    harness.Profiled = KeptProfile
    driver = harness.load_module("drivers", wl["driver"])
    out = driver.run(cfg, wl, seed, seconds, trace, "cuda",
                     time.perf_counter())
    return {"traced": trace, "seed": seed, "correct": bool(out["correct"]),
            "sample_seq_per_s": out["e2e"]["sample_seq_per_s"],
            "setup_s": out["e2e"]["setup_s"]}


def table(session) -> dict:
    """Per span name: count, host, device and self ms; per batch: wall,
    collector and off-CPU ms; the counters with their calls."""
    child_ns = defaultdict(int)
    for s in session.spans:
        if s.parent is not None:
            child_ns[s.parent] += s.end_ns - s.start_ns
    rows = {}
    for s in session.spans:
        r = rows.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                     "device_ms": None, "self_ms": 0.0})
        r["count"] += 1
        r["host_ms"] += 1e-6 * (s.end_ns - s.start_ns)
        r["self_ms"] += 1e-6 * (s.end_ns - s.start_ns - child_ns[s.id])
        if s.device_ms is not None:
            r["device_ms"] = (r["device_ms"] or 0.0) + s.device_ms
    batches = []
    for b in session.spans:
        if b.name != "eval.batch":
            continue
        wall = b.end_ns - b.start_ns
        gc_ns = sum(s.end_ns - s.start_ns for s in session.spans
                    if s.name == "host.gc" and s.batch == b.id)
        batches.append({"b": b.attrs.get("b"), "wall_ms": 1e-6 * wall,
                        "gc_ms": 1e-6 * gc_ns,
                        "offcpu_ms": 1e-6 * (
                            wall - (b.cpu_end_ns - b.cpu_start_ns))})
    counters = {k: {"value": v, "calls": session.calls[k]}
                for k, v in session.counters.items()}
    return {"spans": rows, "batches": batches, "counters": counters}


def show(t: dict) -> None:
    print(f"{'span':<18} {'count':>7} {'host ms':>11} {'device ms':>11} "
          f"{'self ms':>11} {'host/call':>10} {'dev/call':>10}")
    for name, r in sorted(t["spans"].items(),
                          key=lambda kv: -kv[1]["host_ms"]):
        n = r["count"]
        dev = float("nan") if r["device_ms"] is None else r["device_ms"]
        print(f"{name:<18} {n:>7} {r['host_ms']:>11.3f} {dev:>11.3f} "
              f"{r['self_ms']:>11.3f} {r['host_ms'] / n:>10.4f} "
              f"{dev / n:>10.4f}")
    for b in t["batches"]:
        print(f"batch {b['b']}: wall {b['wall_ms']:.3f} ms, host.gc "
              f"{b['gc_ms']:.3f} ms, off-CPU {b['offcpu_ms']:.3f} ms")
    for name, c in t["counters"].items():
        print(f"counter {name}: {c['value']} over {c['calls']} additions")
    for name, ms in t.get("gaps", []):
        print(f"idle gap {ms:.3f} ms under {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json's)")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_span_table: no CUDA device", file=sys.stderr)
        return 2
    from interdiff_torch.utils import profiling

    harness.set_caches()
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    seconds = args.seconds or harness.benchmark()["run_seconds"]
    print(f"card: {harness.power_limit()}; cell {args.workload}, "
          f"{seconds} s windows", flush=True)
    runs, ratios = [], []
    for k in range(args.pairs):
        order = (False, True) if k % 2 == 0 else (True, False)
        pair = {}
        for trace in order:
            r = run_once(wl, cfg, args.seed + k, seconds, trace)
            runs.append(r)
            pair[trace] = r["sample_seq_per_s"]
            print(json.dumps(r), flush=True)
        ratios.append(pair[True] / pair[False])
        print(f"pair {k}: traced / untraced window rate {ratios[-1]:.4f}",
              flush=True)
    t = table(profiling.last_session())
    if KeptProfile.last is not None:
        t["gaps"] = gaps_by_span(KeptProfile.last.segments)
    show(t)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": harness.power_limit(), "runs": runs,
                       "ratios": ratios, **t}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
