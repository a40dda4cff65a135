"""The two readings that every limit of a cell is set from: the program's
gaps (the lower reading) and the control's (the upper), on several seeds
in one process, a short window each.

    python3 bench_port/tools/readings.py --workload CELL \
        --seeds 1,2,3 [--seconds S] [--control 0|1] --out DIR/name.jsonl

The control is the reference computed in TF32 (the precision below the
configuration's float32 with TF32 off) and put in the program's place: its
steps from the program's states and its metrics from the program's
samples, compared with the reference in float32 as the program is."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from bench_port import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    harness.set_caches()
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    driver = harness.load_module("drivers", wl["driver"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        out = driver.run(cfg, wl, int(seed), args.seconds, False, "cuda",
                         t0, control=bool(args.control))
        row = {"cell": args.workload, "seed": seed,
               "correct": out["correct"], "attempted": out["attempted"],
               "program": {k: v["value"] for k, v in out["compared"].items()},
               "control": out.get("control"),
               "wall_s": time.perf_counter() - t0}
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
