"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. build: compiles kernel K1 (`interdiff_torch/csrc/ball_group.cu`) with nvcc.
2. kernels: K1 against its plain PyTorch version on the card at the
   main-path shape (B=32 clouds, N=2048 points, M=1024 centers, C=4, both
   radius scales), bitwise; kernel and plain times by CUDA events (median of
   30 runs after warm-up) beside the byte bound of this run's data.  Also
   bitwise on a small cloud with zero-hit and short rows, M=120 and C=3.
3. slice_cpu_vs_gpu: the no-correction sampler at small size (3 layers,
   d=32, "10" respacing) on the card and on the CPU with the same weights
   and noise; the card's result must lie within 1e-5 (summation order on
   the card differs from the CPU's; the two have differed by 1.4e-6 on an
   H100, and a loss of f32 precision such as TF32 would exceed it).
4. sampler: the main path at full width, as `cli/eval_smpl_short.py` drives
   it in `--mode no_correction`: `MDMSmpl` defaults, 32 clips of 35 frames
   with 2048 object points, one `encode` (K1 must launch exactly twice),
   2-fold diverse tiling to 64 rows, one `make_sampler(reuse_memory=True)`
   call with 1000 DDPM steps; output finite, [64, 35, 144], past frames
   equal to gt.
5. profile: a 10-step respaced sampler call at full width under
   torch.profiler: device busy time against wall time.

Then the card's name and power limit (nvidia-smi), the kernel table as one
JSON line, and the device line.  Weights and data come from numpy seeds;
no file outside this repository and no network is needed.  The run uses one
card: it sees only device 0 unless CUDA_VISIBLE_DEVICES says otherwise, and
stops if that shows more than one.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")  # before CUDA starts

import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
SEED = 233


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median time of ``fn()`` on the card, one pair of CUDA events per run."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def object_cloud(rng, batch: int, points: int) -> np.ndarray:
    """Points and normals [batch, points, 6] on ellipsoid surfaces with
    BEHAVE-object-sized semi-axes (0.1-0.4 m)."""
    axes = rng.uniform(0.1, 0.4, (batch, 1, 3))
    d = rng.standard_normal((batch, points, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    xyz = d * axes
    normals = xyz / axes ** 2
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return np.concatenate([xyz, normals], -1).astype(np.float32)


def seeded_state(model: torch.nn.Module, seed: int) -> dict:
    """Random weights for every tensor of ``model`` from a numpy seed, at
    the scales of the modules' own initialisers."""
    rng = np.random.default_rng(seed)
    state = {}
    for name, t in model.state_dict().items():
        shape, leaf = tuple(t.shape), name.rsplit(".", 1)[-1]
        if leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "running_mean":
            v = rng.standard_normal(shape) * 0.1
        elif leaf == "weight" and len(shape) == 1:  # LayerNorm / BatchNorm
            v = 1.0 + rng.standard_normal(shape) * 0.1
        elif leaf in ("bias", "in_proj_bias"):
            v = rng.standard_normal(shape) * 0.02
        elif leaf == "weight":  # Linear [out, in]
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif leaf in ("in_proj_kernel", "wk"):  # [in, ...]
            v = rng.standard_normal(shape) / np.sqrt(shape[0])
        elif leaf == "queries":  # [N, D]
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        else:
            raise KeyError(f"no seeded init for {name}")
        state[name] = torch.as_tensor(v.astype(np.float32))
    return state


def phase_build(group, gpu: str) -> None:
    t0 = time.perf_counter()
    path = group.build()
    emit({"phase": "build", "gpu": gpu, "kernel": "K1", "library": path,
          "seconds": time.perf_counter() - t0})


def _k1_edge_rows(group, pointcloud) -> dict:
    """K1 against its plain version on the rows the main-path data rarely
    has: zero-hit and short rows, M not a multiple of the block, and C = 3
    (no features).  Returns the row counts the comparison covered."""
    rng = np.random.default_rng(SEED + 3)
    B, N, M = 2, 256, 120
    xyz = np.concatenate([rng.normal(0.0, 0.015, (B, N // 4, 3)),
                          rng.uniform(-0.4, 0.4, (B, N - N // 4, 3))], 1)
    new_xyz = xyz[:, :M].copy()
    new_xyz[:, -8:] += 3.0  # far from every point: zero-hit rows
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device="cuda")
    new_xyz = torch.as_tensor(new_xyz, dtype=torch.float32, device="cuda")
    d2t = group.pairwise_sqdist_t(xyz, new_xyz).contiguous()
    feats = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    rows = {"zero_hit": 0, "short": 0, "full": 0}
    for data in (torch.cat([xyz, feats], -1).contiguous(), xyz):
        for radius, S in ((0.05, 16), (0.1, 32)):
            got = group.group_cuda(d2t, data, new_xyz, radius, S)
            want = group.group_plain(d2t, data, new_xyz, radius, S)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K1 differs from its plain version on "
                                     f"edge rows, C={data.shape[-1]}, "
                                     f"r={radius}")
            hits = (d2t < pointcloud.radius_sq(radius)).sum(dim=1)
            rows["zero_hit"] += int((hits == 0).sum())
            rows["short"] += int(((hits > 0) & (hits < S)).sum())
            rows["full"] += int((hits >= S).sum())
    if min(rows.values()) == 0:
        raise AssertionError(f"edge check missed a row kind: {rows}")
    return rows


def phase_kernels(group, pointcloud, gpu: str) -> dict:
    """K1 at the main-path shape against its plain version, both scales,
    and on edge rows."""
    rng = np.random.default_rng(SEED)
    B, N, M = 32, 2048, 1024
    dev = torch.device("cuda")
    xyz = torch.from_numpy(object_cloud(rng, B, N)[..., :3]).to(dev)
    new_xyz = pointcloud.gather_points(
        xyz, pointcloud.hierarchical_fps(xyz, M, 16)).contiguous()
    data = torch.cat([xyz, torch.linalg.norm(xyz, dim=-1, keepdim=True)],
                     -1).contiguous()
    d2t = group.pairwise_sqdist_t(xyz, new_xyz).contiguous()
    scales, total = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "bytes": 0, "ops": 0, "max_abs_err": 0.0}
    for radius, S in ((0.05, 16), (0.1, 32)):
        got = group.group_cuda(d2t, data, new_xyz, radius, S)
        want = group.group_plain(d2t, data, new_xyz, radius, S)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"r={radius}, S={S}")
        err = float((got - want).abs().max())
        ms = cuda_ms(lambda: group.group_cuda(d2t, data, new_xyz, radius, S))
        plain_ms = cuda_ms(
            lambda: group.group_plain(d2t, data, new_xyz, radius, S))
        # bytes this run's data needs: each query reads d2t up to the
        # candidate that fills its last slot (all N when the row is short)
        inside = d2t < pointcloud.radius_sq(radius)
        rank = torch.cumsum(inside, dim=1)  # [B, N, M]
        full = rank[:, -1] >= S
        reads = torch.where(full, (rank < S).sum(dim=1) + 1,
                            torch.full_like(rank[:, -1], N))
        n_bytes = int(reads.sum()) * 4 + 4 * (B * N * 4 + B * M * 3
                                              + B * M * S * 4)
        n_ops = int(reads.sum())  # one compare per candidate read
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3
        hits = rank[:, -1]
        scales.append({
            "radius": radius, "nsample": S, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bytes": n_bytes,
            "full_d2t_bytes": B * N * M * 4, "max_abs_err": err,
            "rows_full": float(full.float().mean()),
            "rows_zero_hit": float((hits == 0).float().mean()),
            "library_ms": None})
        for k in ("ms", "plain_ms", "bound_ms"):
            total[k] += scales[-1][k]
        total["bytes"] += n_bytes
        total["ops"] += n_ops
        total["max_abs_err"] = max(total["max_abs_err"], err)
    emit({"phase": "kernels", "gpu": gpu, "shape": [B, N, M, 4],
          "bitwise_equal": True, "scales": scales,
          "edge_rows_bitwise_equal": _k1_edge_rows(group, pointcloud)})
    total["bound_by"] = ("bytes" if total["bytes"] / HBM_BYTES_PER_S
                         >= total["ops"] / F32_OPS_PER_S else "operations")
    return total


def _small_sampler_run(device, state, gt, pts, noise, step_noise):
    from interdiff_torch.config import DiffusionConfig, SmplTrackConfig
    from interdiff_torch.eval.smpl_short import SmplEvalConfig, make_sampler
    from interdiff_torch.parallel.sample_parallel import (
        tile_for_diverse_samples,
    )

    track = SmplTrackConfig(embedding_dim=32, num_heads=4, ff_size=64,
                            num_layers=3,
                            diffusion=DiffusionConfig(timestep_respacing="10"))
    model = track.build_model(device)
    model.load_state_dict(state, strict=True)
    run = make_sampler(SmplEvalConfig(), model, track.diffusion.build(device),
                       reuse_memory=True)
    gt, pts = gt.to(device), pts.to(device)
    memory = model.encode(gt, pts)
    gt, pts, memory = tile_for_diverse_samples((gt, pts, memory), 2)
    return run(gt, pts, None, None, memory, noise=noise.to(device),
               step_noise=step_noise.to(device)).cpu()


def phase_slice_cpu_vs_gpu(gpu: str) -> None:
    from interdiff_torch.config import SmplTrackConfig

    rng = np.random.default_rng(35)
    B, T, P = 2, 35, 64
    gt = torch.from_numpy(
        (rng.standard_normal((B, T, 144)) * 0.5).astype(np.float32))
    pts_np = rng.uniform(-0.12, 0.12, (B, P, 6)).astype(np.float32)
    xyz = pts_np[..., :3].astype(np.float64)
    d2 = ((xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    margin = min(float(np.abs(d2 - np.float32(r * r)).min())
                 for r in (0.05, 0.1, 0.2))
    if margin <= 1e-6:  # a pair on a radius could flip between devices
        raise AssertionError(f"cloud has a pair {margin} from a radius")
    pts = torch.from_numpy(pts_np)
    noise = torch.from_numpy(
        rng.standard_normal((2 * B, T, 144)).astype(np.float32))
    step_noise = torch.from_numpy(
        rng.standard_normal((10, 2 * B, T, 144)).astype(np.float32))
    state = seeded_state(SmplTrackConfig(
        embedding_dim=32, num_heads=4, ff_size=64,
        num_layers=3).build_model("cpu"), SEED)
    cpu = _small_sampler_run("cpu", state, gt, pts, noise, step_noise)
    cuda = _small_sampler_run("cuda", state, gt, pts, noise, step_noise)
    err = float((cpu - cuda).abs().max())
    tol = 1e-5  # about 7x the 1.4e-6 measured on an H100; TF32 exceeds it
    emit({"phase": "slice_cpu_vs_gpu", "gpu": gpu, "rows": 2 * B,
          "steps": 10, "max_abs_err": err, "tolerance": tol,
          "tolerance_reason": "summation order of the card's kernels, "
                              "full f32 (no TF32)"})
    if not err <= tol:
        raise AssertionError(f"card vs CPU differ by {err} > {tol}")


def _main_path_inputs(rng, B, T, P, device):
    from interdiff_torch.models.mdm_smpl import smpl_gt_from_raw

    raw = [rng.standard_normal((B, T, 66)) * 0.4,
           rng.standard_normal((B, T, 3)) * 0.5,
           rng.standard_normal((B, T, 3)),
           rng.standard_normal((B, T, 3)) * 0.5]
    raw = [torch.from_numpy(a.astype(np.float32)).to(device) for a in raw]
    gt = smpl_gt_from_raw(*raw)
    pts = torch.from_numpy(object_cloud(rng, B, P)).to(device)
    hand = torch.zeros((B, T, 90), device=device)
    betas = torch.zeros((B, T, 10), device=device)
    return gt, pts, hand, betas


def phase_sampler(group, gpu: str) -> int:
    from interdiff_torch.config import SmplTrackConfig
    from interdiff_torch.eval.smpl_short import SmplEvalConfig, make_sampler
    from interdiff_torch.parallel.sample_parallel import (
        tile_for_diverse_samples,
    )

    rng = np.random.default_rng(SEED)
    B, T, P, fold = 32, 35, 2048, 2
    cfg = SmplEvalConfig()
    track = SmplTrackConfig()
    model = track.build_model()
    model.load_state_dict(seeded_state(model, SEED + 1), strict=True)
    diffusion = track.diffusion.build()
    run = make_sampler(cfg, model, diffusion, reuse_memory=True)
    gt, pts, hand, betas = _main_path_inputs(rng, B, T, P, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    group.launches = 0
    t0 = time.perf_counter()
    memory = model.encode(gt, pts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    encode_launches = group.launches
    gt_f, pts_f, hand_f, betas_f, memory_f = tile_for_diverse_samples(
        (gt, pts, hand, betas, memory), fold)
    x = run(gt_f, pts_f, hand_f, betas_f, memory_f, generator=gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = group.launches

    rows = B * fold
    if encode_launches != 2 or launches != 2:
        raise AssertionError(f"K1 launches: {encode_launches} in encode, "
                             f"{launches} in the run; expected 2")
    if tuple(x.shape) != (rows, T, 144) or not bool(torch.isfinite(x).all()):
        raise AssertionError(f"bad sample: shape {tuple(x.shape)}")
    if not torch.equal(x[:, :cfg.past_len], gt_f[:, :cfg.past_len]):
        raise AssertionError("past frames differ from gt")
    emit({"phase": "sampler", "gpu": gpu, "clips": B, "rows": rows,
          "frames": T, "points": P, "steps": diffusion.num_timesteps,
          "encode_ms": (t1 - t0) * 1e3, "sampler_ms": (t2 - t1) * 1e3,
          "seq_per_s": rows / (t2 - t0),
          "ms_per_step": (t2 - t1) * 1e3 / diffusion.num_timesteps,
          "k1_launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches


def phase_profile(gpu: str) -> None:
    """Device busy share of a 10-step full-width sampler call."""
    from torch.profiler import ProfilerActivity, profile

    from interdiff_torch.config import DiffusionConfig, SmplTrackConfig
    from interdiff_torch.eval.smpl_short import SmplEvalConfig, make_sampler

    rng = np.random.default_rng(SEED + 2)
    track = SmplTrackConfig(diffusion=DiffusionConfig(
        timestep_respacing="10"))
    model = track.build_model()
    model.load_state_dict(seeded_state(model, SEED + 1), strict=True)
    diffusion = track.diffusion.build()
    run = make_sampler(SmplEvalConfig(), model, diffusion, reuse_memory=True)
    gt, pts, hand, betas = _main_path_inputs(rng, 64, 35, 2048, "cuda")
    memory = model.encode(gt, pts)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    run(gt, pts, hand, betas, memory, generator=gen)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(gt, pts, hand, betas, memory, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in events) / 1e3
    by_kernel = {}
    for e in events:
        by_kernel[e.name[:60]] = by_kernel.get(e.name[:60], 0.0) + e.device_time
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    emit({"phase": "profile", "gpu": gpu, "rows": 64, "steps": 10,
          "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if events else "not measured",
          "device_idle_share": (1 - busy_ms / wall_ms) if events
          else "not measured",
          "kernel_launches": len(events),
          "top_kernels_ms": {name: us / 1e3 for name, us in top}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: sees {torch.cuda.device_count()} devices, runs "
              "on one: set CUDA_VISIBLE_DEVICES to one card", file=sys.stderr)
        return 2
    from interdiff_torch.ops import group, pointcloud

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_name_and_power()
    phase_build(group, gpu)
    k1 = phase_kernels(group, pointcloud, gpu)
    phase_slice_cpu_vs_gpu(gpu)
    launches = phase_sampler(group, gpu)
    phase_profile(gpu)

    print(gpu)
    emit({"kernels": [{
        "name": "K1 ball_group", "route": "cuda",
        "source": "interdiff_torch/csrc/ball_group.cu",
        "replaces": "interdiff_tpu/ops/pallas_group.py:143",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
