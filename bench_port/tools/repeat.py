"""Run cells of the benchmark several times, one process a run, and keep
each run's result line, its exit code, its wall time and the end of its
standard error.

    python3 bench_port/tools/repeat.py --out DIR/name.jsonl \
        --workload CELL [--workload CELL ...] --seeds 1,2,3 \
        [--seconds S] [--trace 0|1]

Without ``--seconds`` a run measures BENCHMARK.json's ``run_seconds``.
Prints each run's line as it ends and, per cell and metric, the median
and the quartile spread (Python's `statistics.quantiles`) over the runs."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows = []
    for cell in args.workload:
        for seed in args.seeds.split(","):
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, os.path.join(ROOT, "bench_port", "run.py"),
                 "--workload", cell, "--seed", seed, "--seconds",
                 str(seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            lines = p.stdout.strip().splitlines()
            try:
                result = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                result = None
            row = {"cell": cell, "seed": seed, "trace": args.trace,
                   "rc": p.returncode, "wall_s": time.perf_counter() - t0,
                   "result": result, "stderr": p.stderr[-3000:]}
            rows.append(row)
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(json.dumps({k: row[k] for k in ("cell", "seed", "rc",
                                                  "wall_s", "result")}),
                  flush=True)
            if result is None:
                print(p.stderr[-3000:], flush=True)
    for cell in args.workload:
        runs = [r["result"] for r in rows if r["cell"] == cell
                and r["result"]]
        names = sorted({k for r in runs for k in r["metrics"]})
        for name in names:
            v = [r["metrics"][name]["value"] for r in runs
                 if name in r["metrics"]]
            med = statistics.median(v)
            q = statistics.quantiles(v, n=4) if len(v) > 1 else [med] * 3
            print(f"{cell} {name}: n={len(v)} median={med!r} "
                  f"spread={(q[2] - q[0]) / med if med else 0.0!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
