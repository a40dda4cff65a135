"""Where a cell's run-to-run spread comes from: runs of eval cells under
several host settings, interleaved, each run a process of its own, with
the seconds of every batch of its window.

    python3 bench_port/tools/noise.py --out DIR/name.jsonl \
        --workload CELL [--workload CELL ...] --seeds 1,2 [--modes A,P,T] \
        [--seconds S]

Modes: ``A`` the benchmark as it runs; ``P`` the process pinned to one
CPU; ``T`` one intra-op thread (``OMP_NUM_THREADS=1`` and
``torch.set_num_threads(1)``).  Each seed runs every mode, the order of
the modes turning from seed to seed.  A run is `bench_port/run.py` itself,
driven through `runpy`; only `sampling.window_batches` and `sampling.
Means` are wrapped, to stamp when each batch is asked for and when its
report comes.  Prints each run's rate and batch seconds, then per cell
and mode the median and the quartile spread (Python's `statistics.
quantiles`) of the rate, and of the batch seconds within runs."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

WRAP = r'''
import json, os, runpy, sys, time
mode = sys.argv[1]
if mode == "P":
    os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[-1]})
if mode == "T":
    os.environ["OMP_NUM_THREADS"] = "1"
sys.argv = ["bench_port/run.py"] + sys.argv[2:]
sys.path.insert(0, os.getcwd())
import torch
if mode == "T":
    torch.set_num_threads(1)
from bench_port import sampling
asked, reported = [], []
batches = sampling.window_batches
def window_batches(make, seconds, t_start):
    for b in batches(make, seconds, t_start):
        asked.append(time.perf_counter())
        yield b
sampling.window_batches = window_batches
means_call = sampling.Means.__call__
def report(self, nb, running):
    reported.append(time.perf_counter())
    return means_call(self, nb, running)
sampling.Means.__call__ = report
try:
    runpy.run_path("bench_port/run.py", run_name="__main__")
finally:
    print("batch_s " + json.dumps([r - a for a, r in zip(asked, reported)]),
          file=sys.stderr, flush=True)
'''


def spread(values):
    med = statistics.median(values)
    if len(values) < 2 or not med:
        return med, 0.0
    q = statistics.quantiles(values, n=4)
    return med, (q[2] - q[0]) / med


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="A,P,T")
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    modes = args.modes.split(",")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    rows = []
    for i, seed in enumerate(args.seeds.split(",")):
        for cell in args.workload:
            turned = modes[i % len(modes):] + modes[:i % len(modes)]
            for mode in turned:
                p = subprocess.run(
                    [sys.executable, "-c", WRAP, mode, "--workload", cell,
                     "--seed", seed, "--seconds", str(seconds),
                     "--trace", "0"],
                    cwd=ROOT, capture_output=True, text=True)
                lines = p.stdout.strip().splitlines()
                try:
                    result = json.loads(lines[-1]) if lines else None
                except json.JSONDecodeError:
                    result = None
                stamps = [json.loads(ln[len("batch_s "):])
                          for ln in p.stderr.splitlines()
                          if ln.startswith("batch_s ")]
                row = {"cell": cell, "seed": seed, "mode": mode,
                       "rc": p.returncode, "result": result,
                       "batch_s": stamps[-1] if stamps else [],
                       "stderr": p.stderr[-2000:]}
                rows.append(row)
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
                metrics = result and {k: v["value"] for k, v in
                                      result["metrics"].items()}
                print(json.dumps({k: row[k] for k in
                                  ("cell", "seed", "mode", "rc", "batch_s")}
                                 | {"metrics": metrics,
                                    "correct": result and result["correct"]}),
                      flush=True)
                if result is None:
                    print(p.stderr[-2000:], flush=True)
    for cell in args.workload:
        for mode in modes:
            runs = [r for r in rows if r["cell"] == cell
                    and r["mode"] == mode and r["result"]]
            rates = [r["result"]["metrics"]["sample_seq_per_s"]["value"]
                     for r in runs]
            within = [spread(r["batch_s"])[1] for r in runs
                      if len(r["batch_s"]) > 1]
            if rates:
                med, s = spread(rates)
                print(f"{cell} {mode}: n={len(rates)} rate median={med!r} "
                      f"spread={s!r}; batch-seconds spread within runs "
                      f"median={statistics.median(within) if within else None!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
