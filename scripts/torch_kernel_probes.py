"""One-off measurements of kernels of the PyTorch/CUDA port on one NVIDIA
GPU, kept out of `chip_smoke.py`'s every run.

    python3 scripts/torch_kernel_probes.py [k2 k3 k4 k6 k5]  # from the root

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
2. ``k4_settings``: K4 (`nearest_kernel` of `csrc/nn.cu`) at its main-path
   data (2240 frames of 67 markers against 2048 points) built with
   ``-DK4_THREADS -DK4_POINTS -DK4_QCHUNK -DK4_MIN_BLOCKS`` (threads a
   block, points a thread, queries a chunk, blocks an SM the registers are
   held to); ``k6_settings``: K6 (`csrc/sa.cu`) at stage 1's data, both
   scales, built with ``-DK6_LOADS -DK6_MIN_BLOCKS`` (loads in flight a
   lane in the walk, blocks an SM the lane kernel's registers are held
   to).  Each bitwise against the default build, with ms (per
   encode for K6; for K4 also the device's ms, calls replayed from a CUDA
   graph), registers, spills and waves; K4's default build also at 32 to 128
   queries a frame (device ms, calls replayed from a CUDA graph).
3. ``k5_host``: host microseconds a call, back to back (3000 calls after
   100, the device drained before and after), of K5's wrapper, its output's
   allocation, its C entry through `ctypes` alone and `torch.gather` on the
   same inputs (stage 1's S=32 indices); and of the two ways to read the
   current stream, ``current_stream().cuda_stream`` and the raw handle.

Every setting's library is built first, all nvcc runs at once.  Exits 2
without a CUDA device.  About two minutes on an H100.
"""

from __future__ import annotations

import concurrent.futures
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
    # K4: threads a block, points a thread, queries a chunk, blocks an SM
    "K4": [{"K4_THREADS": t, "K4_POINTS": g, "K4_QCHUNK": qc,
            "K4_MIN_BLOCKS": mb}
           for t, g, qc, mb in ((128, 16, 32, 5), (128, 16, 32, 4),
                                (128, 16, 32, 6), (128, 8, 32, 6),
                                (64, 16, 16, 8))],
    # K6: loads in flight a lane in the walk, blocks an SM
    "K6": [{"K6_LOADS": ld, "K6_MIN_BLOCKS": mb}
           for ld, mb in ((8, 3), (16, 3), (8, 2), (8, 4), (16, 4))],
}
SOURCES = {"K2": "nn", "K3": "nn", "K4": "nn", "K6": "sa"}


def _defines(setting: dict) -> list:
    return [f"{k}={v}" for k, v in setting.items()]


def build_all(names) -> None:
    """The default libraries and every setting's of the kernels ``names``,
    one nvcc each, all started together."""
    from interdiff_torch.ops import _build

    jobs = [(source, []) for source in ("nn", "sa", "ball_group", "gather")]
    jobs += [(SOURCES[name], _defines(s)) for name in names
             for s in SETTINGS[name]]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for job in [pool.submit(_build.build, *j) for j in jobs]:
            job.result()


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
            defines = _defines(setting)
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


def k4_settings(nn, body) -> dict:
    """K4 at its main-path data in each of its settings."""
    from interdiff_torch.data.constants import MARKERSET_SSM67_SMPLH
    from interdiff_torch.ops import _build

    rng = np.random.default_rng(cs.SEED + 4)
    verts, _, cloud = cs._nn_geometry(
        rng, cs.CLIPS * cs.FOLD * cs.FRAMES, cs.POINTS, body)
    a = verts[:, torch.from_numpy(MARKERSET_SSM67_SMPLH.astype(
        np.int64)).to(cs.DEV)].contiguous()

    def call():
        return nn.nearest_neighbor_cuda(a, cloud)

    want, default_lib, rows = call(), nn._library(), []
    # the default build's device ms (calls replayed from a CUDA graph) at
    # other numbers of queries a frame, the markers repeated: the cost of a
    # query chunk of 32 and of a frame's fixed part
    by_queries = {}
    for n_q in (32, 64, 67, 96, 128):
        x = a[:, torch.arange(n_q, device=a.device) % a.shape[1]].contiguous()
        by_queries[n_q] = cs._replay_ms(
            lambda: nn.nearest_neighbor_cuda(x, cloud), 20)
    try:
        for setting in SETTINGS["K4"]:
            defines = _defines(setting)
            nn._lib = _build.load(nn.SOURCE, nn.C_ENTRIES, defines)
            cs._equal_parts(f"K4 at {setting}", call(), want)
            kernel = next(e for e in _build.ptxas_report(nn.SOURCE, defines)
                          if "nearest_kernel" in e["kernel"])
            rows.append({**setting, "ms": cs.cuda_ms(call),
                         "replay_ms": cs._replay_ms(call, 20),
                         **cs._occupancy(kernel, setting["K4_THREADS"],
                                         a.shape[0])})
    finally:
        nn._lib = default_lib
    return {"probe": "k4_settings", "shape": list(a.shape[:2])
            + [cloud.shape[1]], "bitwise_equal": True,
            "device_ms_by_queries": by_queries, "settings": rows}


def k6_settings(sa, group, pointcloud) -> dict:
    """K6 at stage 1's data, both scales, in each of its settings."""
    from interdiff_torch.ops import _build

    data, new_xyz, d2t = cs._stage1_inputs(group, pointcloud)
    B, N, M = d2t.shape
    C = data.shape[-1]
    scales = []
    with torch.no_grad():
        for i, ((radius, S), channels) in enumerate(zip(cs.SCALES,
                                                        cs.STAGE1_MLPS)):
            params = sa.folded_affine(cs._seeded_shared_mlp(
                C, channels, cs.SEED + 8 + i))
            n_params = sum(w.numel() + a.numel() + b.numel()
                           for w, a, b in params)
            scales.append((radius, S, channels, params, n_params))

        def encode():
            return [sa.sa_cuda(d2t, data, new_xyz, p, r, S)
                    for r, S, _, p, _ in scales]

        want, default_lib, rows = encode(), sa._library(), []
        try:
            for setting in SETTINGS["K6"]:
                defines = _defines(setting)
                sa._lib = _build.load(sa.SOURCE, sa.C_ENTRIES, defines)
                for got, w in zip(encode(), want):
                    if not torch.equal(got.view(torch.int32),
                                       w.view(torch.int32)):
                        raise AssertionError(f"K6 at {setting} differs")
                report = _build.ptxas_report(sa.SOURCE, defines)
                rows.append({**setting, "ms_per_encode": cs.cuda_ms(encode),
                             "scales": [cs._occupancy(
                                 next(e for e in report
                                      if f"sa_lane_kernelILi{C}ELi{ch[0]}E"
                                      in e["kernel"]), 256,
                                 B * -(-M // 32), cs._k6_smem(N, S, n))
                                 for _, S, ch, _, n in scales]})
        finally:
            sa._lib = default_lib
    return {"probe": "k6_settings", "shape": [B, N, M, C],
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
    from interdiff_torch.ops import gather, group, nn, pointcloud, sa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_name_and_power())
    body = build_smpl_body(seed=cs.SEED, num_verts=cs.VERTS)
    probes = {"k2": lambda: sweep_settings(nn, body, "K2"),
              "k3": lambda: sweep_settings(nn, body, "K3"),
              "k4": lambda: k4_settings(nn, body),
              "k6": lambda: k6_settings(sa, group, pointcloud),
              "k5": lambda: k5_host(gather, group, pointcloud)}
    keys = sys.argv[1:] or list(probes)
    build_all([k.upper() for k in keys if k.upper() in SETTINGS])
    for key in keys:
        print(json.dumps(probes[key]()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
