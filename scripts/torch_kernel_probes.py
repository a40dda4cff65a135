"""One-off measurements of three kernels of the PyTorch/CUDA port on one
NVIDIA GPU, kept out of `chip_smoke.py`'s every run.

    python3 scripts/torch_kernel_probes.py      # from the repository root

Prints the card's name and power limit, then one JSON line each:

1. ``k2_settings`` and ``k3_settings``: K2 and K3
   (`interdiff_torch/csrc/nn.cu`, one sweep body) at `chip_smoke.py`'s
   main-path data (1600 frames, N=2048, M=6890) in several settings of
   their sweep (threads a block T, queries a thread Q, scores a group G),
   each a library built with ``-DK2_THREADS -DK2_QUERIES -DK2_GROUP`` or
   ``-DK3_THREADS -DK3_QUERIES``: bitwise against the default build, ms a
   call (CUDA events, median of 30), device ms of each kernel
   (torch.profiler), ptxas's registers and spills of the sweep and the
   waves of its launch.
2. ``k5_host``: host microseconds a call, back to back (3000 calls after
   100, the device drained before and after), of K5's wrapper, its output's
   allocation, its C entry through `ctypes` alone and `torch.gather` on the
   same inputs (stage 1's S=32 indices); and of the two ways to read the
   current stream, ``current_stream().cuda_stream`` and the raw handle.

Exits 2 without a CUDA device.  About a minute on an H100.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

# sweep settings: K2's (threads a block T, queries a thread Q, scores a
# group G) and K3's (T, Q; G = 8), each a build with these -D definitions
SETTINGS = {
    "K2": [{"K2_THREADS": t, "K2_QUERIES": q, "K2_GROUP": g}
           for t, q, g in ((128, 8, 8), (256, 4, 8), (256, 8, 8))],
    "K3": [{"K3_THREADS": t, "K3_QUERIES": q}
           for t, q in ((256, 8), (256, 4), (128, 8), (64, 8))],
}


def sweep_settings(nn, body, name: str) -> dict:
    """K2 or K3 at the main-path data in each of its settings: bitwise
    against the default build, ms a call, device ms by kernel, ptxas's
    registers and spills of the sweep and the waves of its launch."""
    from interdiff_torch.ops import _build

    rng = np.random.default_rng(cs.SEED + 4)
    verts, normals, cloud = cs._nn_geometry(
        rng, cs.CLIPS * cs.FOLD * cs.FRAMES, cs.POINTS, body)
    F = cs.CLIPS * cs.FOLD * cs.FUTURE
    a, b, n = cloud[:F], verts[:F], normals[:F]
    N = a.shape[1]

    def call():
        if name == "K2":
            return nn.signed_nearest_pruned_cuda(a, b, n, 0.25)
        return nn.signed_nearest_cuda(a, b, n)

    want, default_lib, rows = call(), nn._library(), []
    full = "Lb1E" if name == "K3" else "Lb0E"
    try:
        for setting in SETTINGS[name]:
            defines = [f"{k}={v}" for k, v in setting.items()]
            nn._lib = _build.load(nn.SOURCE, nn.C_ENTRIES, defines)
            cs._equal_parts(f"{name} at {setting}", call(), want)
            sweep = next(e for e in _build.ptxas_report(nn.SOURCE, defines)
                         if "signed_sweep_kernel" in e["kernel"]
                         and full in e["kernel"])
            T, Q = list(setting.values())[:2]
            rows.append({**setting, "ms": cs.cuda_ms(call),
                         "device_ms_by_kernel": cs._device_ms_by_kernel(call),
                         **cs._occupancy(sweep, T, F * -(-N // (T * Q)))})
    finally:
        nn._lib = default_lib
    return {"probe": f"{name.lower()}_settings", "frames": F,
            "bitwise_equal": True, "settings": rows}


def _host_us(fn, calls: int = 3000) -> float:
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def k5_host(gather, group, pointcloud) -> dict:
    data, new_xyz, d2t = cs._stage1_inputs(group, pointcloud)
    B, N, C = data.shape
    idx = pointcloud.ball_query(data[..., :3], new_xyz, *cs.SCALES[1],
                                d2=d2t.transpose(1, 2)).reshape(B, -1)
    K = idx.shape[1]
    pick = idx[..., None].expand(-1, -1, C)
    out = gather.gather_rows_cuda(data, idx)
    args = (data.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, C, K, 1,
            torch._C._cuda_getCurrentRawStream(0))
    entry = gather._library().gather_rows_f32
    return {"probe": "k5_host", "shape": [B, N, C], "K": K, "host_us": {
        "wrapper": _host_us(lambda: gather.gather_rows_cuda(data, idx)),
        "output_allocation": _host_us(lambda: data.new_empty((B, K, C))),
        "ctypes_call": _host_us(lambda: entry(*args)),
        "torch.gather": _host_us(lambda: torch.gather(data, 1, pick)),
        "stream_object": _host_us(
            lambda: torch.cuda.current_stream().cuda_stream, 20000),
        "raw_stream": _host_us(
            lambda: torch._C._cuda_getCurrentRawStream(0), 20000)}}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_probes: no CUDA device", file=sys.stderr)
        return 2
    from interdiff_torch.config import build_smpl_body
    from interdiff_torch.ops import gather, group, nn, pointcloud

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_power())
    body = build_smpl_body(seed=cs.SEED, num_verts=cs.VERTS)
    for line in (sweep_settings(nn, body, "K2"),
                 sweep_settings(nn, body, "K3"),
                 k5_host(gather, group, pointcloud)):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
