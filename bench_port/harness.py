"""What every cell of the benchmark shares: the files found by name, the
seeds, the device's identity, the measured window, the profiled slice, the
forbidden imports and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# H100 SXM data sheet, dense rates, at its 700 W power limit
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "interdiff_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def workload(name: str) -> dict:
    """The cell ``name``: its entry in BENCHMARK.json merged with its file
    ``workloads/<name>.json`` (driver, traffic and limits)."""
    entry = next((w for w in benchmark()["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return {**load_json(HERE, "workloads", name + ".json"), **entry}


def config(name: str) -> dict:
    return load_json(HERE, "configs", name + ".json")


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, by path (a name may hold
    dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_args(cfg: dict, cls) -> dict:
    """The fields of the program's config dataclass ``cls`` that the
    configuration file gives (the others keep their defaults)."""
    import dataclasses

    return {f.name: cfg[f.name] for f in dataclasses.fields(cls)
            if f.name in cfg}


def metric_entries(cell: str, trace: bool) -> List[dict]:
    """The metrics this cell reports: its end-to-end metrics in a timed
    run, its per-layer ones in a traced run."""
    bench = benchmark()
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    if trace:
        # a per-layer metric belongs where the metric it moves is reported
        moved = {m["name"] for m in metric_entries(cell, False)}
        return [m for m in entries if cell in m.get("workloads", [cell])
                and m["moves"] in moved]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def seed_ints(seed: int, *stream: int) -> List[int]:
    """Words for numpy's SeedSequence from any whole ``seed`` (signed, wider
    than 32 bits) and a stream of small ints."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32, *(int(x) % (1 << 32) for x in stream)]


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(seed_ints(seed, *stream))


def torch_seed(seed: int, *stream: int) -> int:
    """A seed for a `torch.Generator`: the first word of the stream."""
    return int(np.random.SeedSequence(seed_ints(seed, *stream))
               .generate_state(1)[0])


def set_caches() -> None:
    """Every cache of the program inside the checkout, at fixed paths."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, ".cache", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, ".cache", "torch_extensions"))


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(trace: Optional[dict] = None) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


# -- the profiled slice ------------------------------------------------------

KERNEL = re.compile(r"(\w+_kernel)")


class Profiled:
    """Segments of ``torch.profiler`` kept in memory: for each, the device
    operations (name, start, end in s) and the host operations, and its
    wall length on the host clock."""

    def __init__(self):
        self.segments: List[dict] = []
        self._prof = None

    @staticmethod
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        self.sync()
        wall = time.perf_counter() - self._t0
        self._prof.stop()
        dev, host = [], []
        for e in self._prof.events():
            span = (e.time_range.start / 1e6, e.time_range.end / 1e6)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # a record_function range drawn on the device's timeline
                # spans idle time too: not an operation
                if not getattr(e, "is_user_annotation", False):
                    dev.append((e.name, *span))
            else:
                host.append((e.name, *span))
        self.segments.append({"wall_s": wall, "device": sorted(
            dev, key=lambda d: d[1]), "host": host})
        self._prof = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def summary(self) -> dict:
        """busy and window seconds, the top device operations and the
        longest idle gaps named by the host operation under them."""
        busy = window = 0.0
        by_name: Dict[str, float] = {}
        gaps = []
        for seg in self.segments:
            window += seg["wall_s"]
            end = None
            for name, s, e in seg["device"]:
                m = KERNEL.search(name)
                key = m.group(1) if m else name[:60]
                by_name[key] = by_name.get(key, 0.0) + (e - s)
                if end is None:
                    busy += e - s
                elif s > end:
                    busy += e - s
                    gaps.append((s - end, end, s, seg))
                elif e > end:
                    busy += e - end
                end = e if end is None else max(end, e)
        gaps.sort(key=lambda g: -g[0])
        named = []
        for length, s, e, seg in gaps[:10]:
            mid = 0.5 * (s + e)
            under = [h for h in seg["host"] if h[1] <= mid <= h[2]]
            label = min(under, key=lambda h: h[2] - h[1])[0] if under \
                else "host outside any operator"
            named.append([label, length])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": window,
                "device_ops": [[k, v] for k, v in top], "idle_gaps": named}

    def kernels(self) -> List[tuple]:
        """(kernel name, device seconds) of every launch of a hand-written
        kernel, in launch order."""
        out = []
        for seg in self.segments:
            for name, s, e in seg["device"]:
                m = KERNEL.search(name)
                if m:
                    out.append((m.group(1), e - s))
        return out


# -- the result -------------------------------------------------------------

def emit(result: dict, compared: Dict[str, dict]) -> None:
    """The numbers compared on standard error, each beside its limit, then
    the result line, with them under ``compared`` last."""
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps({**result, "compared": compared}), flush=True)
