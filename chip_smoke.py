"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure exits non-zero):

1. build: compiles `interdiff_torch/csrc/ball_group.cu` (kernel K1) and
   `interdiff_torch/csrc/nn.cu` (K2, K3, K4) with nvcc, both at once.
2. kernels: each kernel against its plain PyTorch version on the card,
   bitwise, at the main-path shapes; kernel and plain times by CUDA events
   (median of 30 runs after warm-up) beside the bound of this run's data.
   K1: B=32 clouds, N=2048 points, M=1024 centers, C=4, both radius scales,
   and a small cloud with zero-hit and short rows, M=120 and C=3.
   K2, K3: 1600 frames of N=2048 object points against the M=6890 vertices
   and normals of the posed stand-in body; the plain versions on the first
   16 frames (a full [1600, 2048, 6890] score tensor is 90 GB); K2 against
   K3 on all frames (bit-equal inside delta, forced beyond).  The object
   clouds are placed so that the run covers penetrating queries, queries
   inside delta outside the body, queries beyond delta, frames with some
   segments skipped and frames with every segment skipped.  K4: 2240 frames
   of 67 markers against 2048 points, whole.  All three also on a small
   case with duplicated surface rows (exact ties), a one-point cloud and an
   all-far frame.
3. slice_cpu_vs_gpu: the small sampler (3 layers, d=32, "10" respacing) on
   the card and on the CPU with the same weights and noise, without
   correction (within 1e-5) and with correction in the loop on a 256-vertex
   stand-in body (tolerance and reason in the line; no gate value within
   reach of its threshold, and the same rows corrected on both).
4. sampler: the main path at full width, as `cli/eval_smpl_short.py` drives
   it: `MDMSmpl` defaults, 32 clips of 35 frames with 2048 object points,
   one `encode` (K1 launches twice), 2-fold diverse tiling to 64 rows, one
   `make_sampler(use_correction=True)` call with 1000 DDPM steps on the
   V=6890 stand-in body: 11 firings of the correction (K2 and K4 launch 11
   times each), with the hook's time and the shares of flagged segments,
   penetrating queries and corrected rows of each firing; output finite,
   [64, 35, 144], body block of the past frames equal to gt.  The
   denoiser's output layers are biased to the rest pose (see
   `full_width_models`) so that the object lies within reach of the body.  Then the same with
   `nn_prune_delta=None` at "100" respacing (2 firings, through K3), and
   the no-correction sampler at 1000 steps (past frames equal to gt).
5. profile: a 10-step respaced corrected sampler call at full width (two
   firings) under torch.profiler: device busy time against wall time.

Then the card's name and power limit (nvidia-smi), the kernel table as one
JSON line, and the device line.  Weights and data come from numpy seeds;
no file outside this repository and no network is needed.  The run uses one
card: it sees only device 0 unless CUDA_VISIBLE_DEVICES says otherwise, and
stops if that shows more than one.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")  # before CUDA starts

import torch  # noqa: E402

# card against CPU on the small corrected sampler: about 14x the 3.5e-6
# measured on an H100
CORRECTED_TOL = 5e-5
CORRECTED_TOL_REASON = ("summation order of the card's kernels through FK, "
                        "the 6D-to-axis-angle conversion and the projector, "
                        "full f32 (no TF32)")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
# K2-K4, per pair: 3 mul + 2 add (a.b), 1 mul + 1 sub (score), 1 compare
NN_OPS_PER_PAIR = 8
SEED = 233
DEV = "cuda"
# the main path's sizes: 32 clips x 2 diverse samples of 35 frames (10 past,
# 25 future), 2048 object points, the SMPL-H body's 6890 vertices
CLIPS, FOLD, FRAMES, FUTURE, POINTS, VERTS = 32, 2, 35, 25, 2048, 6890


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
        elif leaf in ("queries", "T", "S", "A"):  # [..., N, D]
            v = rng.standard_normal(shape) / np.sqrt(shape[-1])
        elif leaf == "prelu":
            v = np.float32(0.25)
        else:
            raise KeyError(f"no seeded init for {name}")
        state[name] = torch.as_tensor(np.asarray(v, dtype=np.float32))
    return state


def phase_build(group, nn, gpu: str) -> None:
    """Both libraries, one nvcc each, started together."""
    def timed(kernels, module):
        t0 = time.perf_counter()
        path = module.build()
        return {"phase": "build", "gpu": gpu, "kernels": kernels,
                "library": path, "seconds": time.perf_counter() - t0}

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(timed, "K1", group),
                pool.submit(timed, "K2 K3 K4", nn)]
        for job in jobs:
            emit(job.result())


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
    xyz = torch.as_tensor(xyz, dtype=torch.float32, device=DEV)
    new_xyz = torch.as_tensor(new_xyz, dtype=torch.float32, device=DEV)
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
    B, N, M = CLIPS, POINTS, 1024
    xyz = torch.from_numpy(object_cloud(rng, B, N)[..., :3]).to(DEV)
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
    total["library_ms"] = None
    total["bound_by"] = ("bytes" if total["bytes"] / HBM_BYTES_PER_S
                         >= total["ops"] / F32_OPS_PER_S else "operations")
    return total


def _nn_geometry(rng, frames: int, points: int, body):
    """The stand-in body posed ``frames`` times with its vertex normals, and
    one ellipsoid object cloud per frame, its centre on a body vertex pushed
    out along that vertex's normal by 0, 0.35, 0.6 or 1.2 m (frame index
    mod 4): straddling the surface, near it, mostly beyond delta, and beyond
    the reach of every segment."""
    from interdiff_torch.geometry.normals import vertex_normals
    from interdiff_torch.smpl.model import smpl_forward

    def cuda(x):
        return torch.from_numpy(x.astype(np.float32)).to(DEV)

    verts = smpl_forward(
        body, cuda(rng.standard_normal((frames, 3 * body.num_joints)) * 0.3),
        cuda(rng.standard_normal((frames, 10)) * 0.5),
        cuda(rng.standard_normal((frames, 3)) * 0.5))[0].contiguous()
    normals = vertex_normals(verts, body.faces_idx,
                             body.incident).contiguous()
    rows = torch.arange(frames, device=DEV)
    anchor = torch.from_numpy(
        rng.integers(0, body.num_verts, frames)).to(DEV)
    offset = torch.tensor([0.0, 0.35, 0.6, 1.2], device=DEV)[rows % 4]
    center = verts[rows, anchor] + offset[:, None] * normals[rows, anchor]
    cloud = cuda(object_cloud(rng, frames, points)[..., :3]) + center[:, None]
    return verts, normals, cloud.contiguous()


def _equal_parts(name: str, got, want) -> float:
    """Raise unless every output of ``got`` equals ``want`` bit for bit;
    returns the largest absolute difference (0.0)."""
    err = 0.0
    for part, g, w in zip(("sq", "sdot", "idx") if len(got) == 3
                          else ("sq", "idx"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"{name}: {part} differs from its plain "
                                 f"version")
        err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def _nn_edge_rows(nn) -> dict:
    """K2, K3, K4 against their plain versions where the main-path data
    does not go: every surface row duplicated (exact ties, within a tile
    and across tiles), a cloud that is one point, a frame far from
    everything, N and M not multiples of the block and the tile."""
    rng = np.random.default_rng(SEED + 5)
    B, N, M = 3, 130, 300
    half = rng.standard_normal((B, M // 2, 3)) * 0.3
    b = np.concatenate([half, half], 1)
    a = rng.standard_normal((B, N, 3)) * 0.3
    a[1] = b[1, 7] + 0.01  # one point, N times, 0.017 m off the surface
    a[2] += 50.0  # beyond delta of everything
    a, b, n = (torch.from_numpy(x.astype(np.float32)).to(DEV)
               for x in (a, b, rng.standard_normal((B, M, 3))))
    k3 = nn.signed_nearest_cuda(a, b, n)
    _equal_parts("K3 edge rows", k3, nn.signed_nearest_plain(a, b, n))
    k2 = nn.signed_nearest_pruned_cuda(a, b, n, 0.25)
    _equal_parts("K2 edge rows", k2,
                 nn.signed_nearest_pruned_plain(a, b, n, 0.25))
    _equal_parts("K4 edge rows", nn.nearest_neighbor_cuda(a, b),
                 nn.nearest_neighbor_plain(a, b))
    torch.cuda.synchronize()
    d2 = nn.delta_squared(0.25)
    rows = {"tied_winners_first": int((k3[2] < M // 2).sum()),
            "one_point_cloud_inside_delta": int((k2[0][1] < d2).sum()),
            "all_far_forced": int((k2[0][2] == d2).sum())}
    if rows["tied_winners_first"] != B * N or rows["all_far_forced"] != N \
            or rows["one_point_cloud_inside_delta"] != N:
        raise AssertionError(f"edge check missed a row kind: {rows}")
    return rows


def _nn_bound(pairs: int, n_bytes: int):
    ops_s = NN_OPS_PER_PAIR * pairs / F32_OPS_PER_S
    bytes_s = n_bytes / HBM_BYTES_PER_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")


def phase_kernels_nn(nn, body, gpu: str) -> dict:
    """K2, K3, K4 at the shapes one firing of the correction gives them at
    full width (64 rows x 25 future frames, 64 x 35 frames), against their
    plain versions and, K2, against K3."""
    from interdiff_torch.data.constants import MARKERSET_SSM67_SMPLH

    rng = np.random.default_rng(SEED + 4)
    rows_all = CLIPS * FOLD
    F_all, F, N, SUB, delta = (rows_all * FRAMES, rows_all * FUTURE, POINTS,
                               16, 0.25)
    verts, normals, cloud = _nn_geometry(rng, F_all, N, body)
    M = verts.shape[1]
    a, b, n = cloud[:F], verts[:F], normals[:F]
    sub = tuple(x[:SUB] for x in (a, b, n))
    d2 = nn.delta_squared(delta)

    k3 = nn.signed_nearest_cuda(a, b, n)
    k2 = nn.signed_nearest_pruned_cuda(a, b, n, delta)
    torch.cuda.synchronize()
    err = {"K3": _equal_parts("K3", tuple(x[:SUB] for x in k3),
                              nn.signed_nearest_plain(*sub)),
           "K2": _equal_parts("K2", tuple(x[:SUB] for x in k2),
                              nn.signed_nearest_pruned_plain(*sub, delta))}
    near = k3[0] < d2
    for part, g, full, forced in zip(("sq", "sdot", "idx"), k2, k3,
                                     (d2, 1.0, 0)):
        if not torch.equal(g[near], full[near]):
            raise AssertionError(f"K2 {part} differs from K3 inside delta")
        if not bool((g[~near] == forced).all()):
            raise AssertionError(f"K2 {part} is not forced beyond delta")

    flags = nn.segment_flags(a, b, delta)
    n_seg = flags.shape[1]
    seg_points = torch.full((n_seg,), nn.SEGMENT, device=DEV)
    seg_points[-1] = M - (n_seg - 1) * nn.SEGMENT
    flagged_points = int((flags * seg_points).sum())
    per_frame = flags.sum(dim=1)

    def kinds(frames: slice) -> dict:
        nr, sd, pf = near[frames], k3[1][frames], per_frame[frames]
        return {"penetrating": int((nr & (sd < 0)).sum()),
                "inside_delta_outside_body": int((nr & (sd > 0)).sum()),
                "beyond_delta": int((~nr).sum()),
                "frames_some_segments_skipped":
                    int(((pf > 0) & (pf < n_seg)).sum()),
                "frames_every_segment_skipped": int((pf == 0).sum())}

    rows, rows_sub = kinds(slice(None)), kinds(slice(SUB))
    if min(rows_sub.values()) == 0:
        raise AssertionError(f"the frames held against the plain versions "
                             f"miss a row kind: {rows_sub}")

    a4 = verts[:, torch.from_numpy(
        MARKERSET_SSM67_SMPLH.astype(np.int64)).to(DEV)].contiguous()
    k4 = nn.nearest_neighbor_cuda(a4, cloud)
    err["K4"] = _equal_parts("K4", k4, nn.nearest_neighbor_plain(a4, cloud))
    torch.cuda.synchronize()

    out = {}
    pairs = {"K3": F * N * M, "K2": N * flagged_points,
             "K4": F_all * a4.shape[1] * N}
    n_bytes = {"K3": 4 * (3 * F * N + 6 * F * M + 3 * F * N),
               # b once for the flags, n only at the winners inside delta
               "K2": 4 * (3 * F * N + 3 * F * M + 3 * int(near.sum())
                          + 3 * F * N),
               "K4": 4 * (3 * a4.shape[1] * F_all + 3 * F_all * N
                          + 2 * a4.shape[1] * F_all)}
    timed = {
        "K3": (lambda: nn.signed_nearest_cuda(a, b, n),
               lambda: nn.signed_nearest_plain(*sub), None),
        "K2": (lambda: nn.signed_nearest_pruned_cuda(a, b, n, delta),
               lambda: nn.signed_nearest_pruned_plain(*sub, delta), None),
        "K4": (lambda: nn.nearest_neighbor_cuda(a4, cloud),
               lambda: nn.nearest_neighbor_plain(a4, cloud),
               lambda: torch.cdist(a4, cloud).square().min(dim=-1)),
    }
    for name, (kernel, plain, library) in timed.items():
        bound_ms, bound_by = _nn_bound(pairs[name], n_bytes[name])
        out[name] = {
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "plain_frames": F_all if name == "K4" else SUB,
            "frames": F_all if name == "K4" else F,
            "bound_ms": bound_ms, "bound_by": bound_by, "pairs": pairs[name],
            "bytes": n_bytes[name], "max_abs_err": err[name],
            "library_ms": None if library is None else cuda_ms(library)}
    emit({"phase": "kernels", "gpu": gpu, "kernels": "K2 K3 K4",
          "shape_k2_k3": [F, N, M], "shape_k4": [F_all, a4.shape[1], N],
          "delta": delta, "segment": nn.SEGMENT, "bitwise_equal": True,
          "k2_equals_k3_inside_delta_forced_beyond": True,
          "flagged_segment_share": float(flags.float().mean()),
          "flagged_pair_share": pairs["K2"] / pairs["K3"],
          "rows": rows, "rows_held_against_plain": rows_sub,
          "edge_rows_bitwise_equal": _nn_edge_rows(nn), **out})
    return out


SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
SMALL_MARKERS = np.arange(40)


def _small_sampler_run(device, state, inputs, projector_state=None):
    """The small sampler on ``device`` over ``inputs`` (gt, pts, hand,
    betas, noise, step_noise); with ``projector_state`` the correction runs
    in the loop on a 256-vertex stand-in body, firing at t = 9, 6, 3, 0.
    Returns (x, trace)."""
    from interdiff_torch.config import (
        CorrectionConfig,
        DiffusionConfig,
        SmplTrackConfig,
        build_smpl_body,
    )
    from interdiff_torch.eval.smpl_short import SmplEvalConfig, make_sampler
    from interdiff_torch.parallel.sample_parallel import (
        tile_for_diverse_samples,
    )

    track = SmplTrackConfig(**SMALL,
                            diffusion=DiffusionConfig(timestep_respacing="10"))
    model = track.build_model(device)
    model.load_state_dict(state, strict=True)
    trace, extra, cfg = [], {}, SmplEvalConfig()
    if projector_state is not None:
        cfg = SmplEvalConfig(correction_t_max=9, correction_every=3)
        projector = CorrectionConfig(num_nodes=40, dct=4).build_model(device)
        projector.load_state_dict(projector_state, strict=True)
        extra = dict(smpl=build_smpl_body(seed=SEED, num_verts=256,
                                          device=device),
                     projector=projector, use_correction=True,
                     markers_idx=SMALL_MARKERS, trace=trace)
    run = make_sampler(cfg, model, track.diffusion.build(device),
                       reuse_memory=True, **extra)
    gt, pts, hand, betas, noise, step_noise = (t.to(device) for t in inputs)
    memory = model.encode(gt, pts)
    tiled = tile_for_diverse_samples((gt, pts, hand, betas, memory), 2)
    x = run(*tiled, noise=noise, step_noise=step_noise).cpu()
    return x, trace


def _gate_margins(entry: dict, delta: float) -> dict:
    """How far each value the gate compares lies from its threshold."""
    def least(t):
        return float(t.min()) if t.numel() else float("inf")

    d2 = np.float32(delta) ** 2
    swept = entry["o2h_sq"].flatten() != d2
    return {"penetration_0.002": least((entry["penetration"] - 0.002).abs()),
            "distance_0.02": least((entry["distance"] - 0.02).abs()),
            "marker_d_0.02": least((entry["marker_d"] - 0.02).abs()),
            "o2h_sq_delta2": least(
                (entry["o2h_sq"].flatten() - d2).abs()[swept]),
            "o2h_dot_0": least(entry["o2h_dot"].flatten().abs()[swept])}


def phase_slice_cpu_vs_gpu(gpu: str) -> None:
    from interdiff_torch.config import CorrectionConfig, SmplTrackConfig

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
    inputs = (gt, torch.from_numpy(pts_np)) + tuple(
        torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32))
        for shape, scale in (((B, T, 90), 0.1), ((B, T, 10), 0.5),  # hands, betas
                             ((2 * B, T, 144), 1.0),  # noise
                             ((10, 2 * B, T, 144), 1.0)))  # step noise
    state = seeded_state(SmplTrackConfig(**SMALL).build_model("cpu"), SEED)
    cpu, _ = _small_sampler_run("cpu", state, inputs)
    cuda, _ = _small_sampler_run(DEV, state, inputs)
    err = float((cpu - cuda).abs().max())
    tol = 1e-5  # about 7x the 1.4e-6 measured on an H100; TF32 exceeds it
    emit({"phase": "slice_cpu_vs_gpu", "gpu": gpu, "correction": False,
          "rows": 2 * B, "steps": 10, "max_abs_err": err, "tolerance": tol,
          "tolerance_reason": "summation order of the card's kernels, "
                              "full f32 (no TF32)"})
    if not err <= tol:
        raise AssertionError(f"card vs CPU differ by {err} > {tol}")

    projector_state = seeded_state(
        CorrectionConfig(num_nodes=40, dct=4).build_model("cpu"), SEED + 6)
    cpu, cpu_trace = _small_sampler_run("cpu", state, inputs,
                                        projector_state)
    cuda, cuda_trace = _small_sampler_run(DEV, state, inputs,
                                          projector_state)
    err = float((cpu - cuda).abs().max())
    fired = [e["t"] for e in cuda_trace]
    margins = {}
    for c, g in zip(cpu_trace, cuda_trace):
        if not torch.equal(c["condition"], g["condition"].cpu()):
            raise AssertionError(f"gate decisions differ at t={c['t']}")
        for entry in (c, g):
            for k, v in _gate_margins(entry, 0.25).items():
                margins[k] = min(margins.get(k, float("inf")), v)
    # the gate's inputs agree to about 1e-5 between the devices; no value it
    # compares may lie that close to its threshold
    if fired != [9, 6, 3, 0] or min(margins.values()) <= 1e-5:
        raise AssertionError(f"fired at {fired}, margins {margins}")
    tol = CORRECTED_TOL
    emit({"phase": "slice_cpu_vs_gpu", "gpu": gpu, "correction": True,
          "rows": 2 * B, "steps": 10, "fired_at": fired,
          "corrected_rows": [float(e["condition"].float().mean())
                             for e in cuda_trace],
          "least_gate_margins": margins, "max_abs_err": err,
          "tolerance": tol, "tolerance_reason": CORRECTED_TOL_REASON})
    if not err <= tol:
        raise AssertionError(f"corrected sampler: card vs CPU differ by "
                             f"{err} > {tol}")


def _main_path_inputs(rng, B, T, P, device):
    from interdiff_torch.models.mdm_smpl import smpl_gt_from_raw

    raw = [rng.standard_normal((B, T, 66)) * 0.4,
           rng.standard_normal((B, T, 3)) * 0.5,
           rng.standard_normal((B, T, 3)),
           rng.standard_normal((B, T, 3)) * 0.5]
    raw = [torch.from_numpy(a.astype(np.float32)).to(device) for a in raw]
    gt = smpl_gt_from_raw(*raw)
    pts = torch.from_numpy(object_cloud(rng, B, P)).to(device)
    hand = torch.from_numpy(
        (rng.standard_normal((B, T, 90)) * 0.1).astype(np.float32)).to(device)
    betas = torch.from_numpy(np.broadcast_to(
        rng.standard_normal((B, 1, 10)) * 0.5, (B, T, 10)).astype(
            np.float32)).to(device)
    return gt, pts, hand, betas


def full_width_models():
    """The main path's objects at the sizes a user runs: `MDMSmpl` and
    `ObjProjectorSmpl` defaults with seeded weights, the V=6890 stand-in
    body.

    An untrained denoiser puts the object metres from the body, where the
    gate's sweep skips every segment.  A trained one keeps it within reach.
    So the denoiser's two output layers are scaled to a twentieth and their
    biases set to the rest pose with the object 0.25 m to the side of the
    body's centre: the denoised frames then scatter by about 0.05 around an
    object that straddles the body's surface, and the sweep, the contact
    labels and the projector's marker choice all have work to do."""
    from interdiff_torch.config import (
        CorrectionConfig,
        SmplTrackConfig,
        build_smpl_body,
    )

    model = SmplTrackConfig().build_model()
    model.load_state_dict(seeded_state(model, SEED + 1), strict=True)
    identity6d = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    with torch.no_grad():
        for layer, bias in (
                (model.bodyFinalLinear, identity6d * 22 + [0.0, 0.0, 0.0]),
                (model.objFinalLinear, identity6d + [0.25, 0.1, 0.0])):
            layer.weight.mul_(0.05)
            layer.bias.copy_(torch.tensor(bias))
    projector = CorrectionConfig().build_model()
    projector.load_state_dict(seeded_state(projector, SEED + 7), strict=True)
    return model, projector, build_smpl_body(seed=SEED, num_verts=VERTS)


def _reset_launches(group, nn) -> None:
    group.launches = 0
    for name in nn.launches:
        nn.launches[name] = 0


def _read_launches(group, nn) -> dict:
    return {"K1": group.launches, "K2": nn.launches["signed_nearest_pruned"],
            "K3": nn.launches["signed_nearest"],
            "K4": nn.launches["nearest_neighbor"]}


def _check_sample(x, gt, cfg, past_channels: int) -> None:
    if tuple(x.shape) != tuple(gt.shape) or not bool(
            torch.isfinite(x).all()):
        raise AssertionError(f"bad sample: shape {tuple(x.shape)}")
    if not torch.equal(x[:, :cfg.past_len, :past_channels],
                       gt[:, :cfg.past_len, :past_channels]):
        raise AssertionError("past frames differ from gt")


def phase_sampler(group, nn, models, gpu: str) -> dict:
    """The three sampler paths at full width; returns the launches of each
    kernel on the path that runs it."""
    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.eval.smpl_short import SmplEvalConfig, make_sampler
    from interdiff_torch.parallel.sample_parallel import (
        tile_for_diverse_samples,
    )

    rng = np.random.default_rng(SEED)
    B, T, P, fold = CLIPS, FRAMES, POINTS, FOLD
    rows = B * fold
    model, projector, body = models
    diffusion = DiffusionConfig().build()
    gt, pts, hand, betas = _main_path_inputs(rng, B, T, P, DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    common = {"phase": "sampler", "gpu": gpu, "clips": B, "rows": rows,
              "frames": T, "points": P}

    # -- the main path: correction in the loop, pruned sweep, full depth
    cfg = SmplEvalConfig()
    trace, flag_shares = [], []
    run = make_sampler(cfg, model, diffusion, smpl=body, projector=projector,
                       use_correction=True, reuse_memory=True, trace=trace)
    segment_flags = nn.segment_flags

    def recording_flags(a, b, delta):
        flags = segment_flags(a, b, delta)
        flag_shares.append(flags.float().mean())
        return flags

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nn.segment_flags = recording_flags
    try:
        _reset_launches(group, nn)
        t0 = time.perf_counter()
        memory = model.encode(gt, pts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tiled = tile_for_diverse_samples((gt, pts, hand, betas, memory), fold)
        x = run(*tiled, generator=gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _read_launches(group, nn)
    finally:
        nn.segment_flags = segment_flags
    if launches != {"K1": 2, "K2": 11, "K3": 0, "K4": 11}:
        raise AssertionError(f"launches on the corrected path: {launches}")
    _check_sample(x, tiled[0], cfg, 135)  # the blend may move the object
    steps = diffusion.num_timesteps
    firings = [{"t": e["t"], "hook_ms": e["start"].elapsed_time(e["end"]),
                "corrected_rows": float(e["condition"].float().mean()),
                "penetrating_queries": float(
                    (e["o2h_dot"] < 0).float().mean()),
                "flagged_segments": float(share)}
               for e, share in zip(trace, flag_shares)]
    if [f["t"] for f in firings] != list(range(500, -1, -50)):
        raise AssertionError(f"the correction fired at {firings}")
    emit({**common, "path": "correction", "steps": steps,
          "encode_ms": (t1 - t0) * 1e3, "sampler_ms": (t2 - t1) * 1e3,
          "seq_per_s": rows / (t2 - t0),
          "ms_per_step": (t2 - t1) * 1e3 / steps,
          "hook_ms_per_firing": statistics.median(
              f["hook_ms"] for f in firings),
          "firings": firings, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})

    # -- the full sweep (K3) in the loop, depth cut to 100 respaced steps
    cfg_full = SmplEvalConfig(nn_prune_delta=None)
    short = DiffusionConfig(timestep_respacing="100").build()
    trace_full = []
    run_full = make_sampler(cfg_full, model, short, smpl=body,
                            projector=projector, use_correction=True,
                            reuse_memory=True, trace=trace_full)
    _reset_launches(group, nn)
    t0 = time.perf_counter()
    x = run_full(*tiled, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches_full = _read_launches(group, nn)
    if launches_full != {"K1": 0, "K2": 0, "K3": 2, "K4": 2}:
        raise AssertionError(f"launches on the full-sweep path: "
                             f"{launches_full}")
    _check_sample(x, tiled[0], cfg_full, 135)
    emit({**common, "path": "correction, nn_prune_delta=None",
          "steps": short.num_timesteps, "sampler_ms": (t1 - t0) * 1e3,
          "firings": [{"t": e["t"],
                       "hook_ms": e["start"].elapsed_time(e["end"]),
                       "corrected_rows":
                           float(e["condition"].float().mean())}
                      for e in trace_full],
          "launches": launches_full})

    # -- the sampler without correction, full depth
    plain = make_sampler(cfg, model, diffusion, reuse_memory=True)
    _reset_launches(group, nn)
    t0 = time.perf_counter()
    memory = model.encode(gt, pts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tiled = tile_for_diverse_samples((gt, pts, hand, betas, memory), fold)
    x = plain(*tiled, generator=gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches_plain = _read_launches(group, nn)
    if launches_plain != {"K1": 2, "K2": 0, "K3": 0, "K4": 0}:
        raise AssertionError(f"launches without correction: "
                             f"{launches_plain}")
    _check_sample(x, tiled[0], cfg, 144)
    emit({**common, "path": "no correction", "steps": steps,
          "encode_ms": (t1 - t0) * 1e3, "sampler_ms": (t2 - t1) * 1e3,
          "seq_per_s": rows / (t2 - t0),
          "ms_per_step": (t2 - t1) * 1e3 / steps,
          "launches": launches_plain})
    return {**launches, "K3": launches_full["K3"]}


def phase_profile(models, gpu: str) -> None:
    """Device busy share of a 10-step full-width corrected sampler call,
    the correction firing at t = 5 and t = 0."""
    from torch.profiler import ProfilerActivity, profile

    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.eval.smpl_short import SmplEvalConfig, make_sampler

    rng = np.random.default_rng(SEED + 2)
    model, projector, body = models
    diffusion = DiffusionConfig(timestep_respacing="10").build()
    trace = []
    run = make_sampler(SmplEvalConfig(correction_t_max=9, correction_every=5),
                       model, diffusion, smpl=body, projector=projector,
                       use_correction=True, reuse_memory=True, trace=trace)
    gt, pts, hand, betas = _main_path_inputs(rng, CLIPS * FOLD, FRAMES,
                                             POINTS, DEV)
    memory = model.encode(gt, pts)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    run(gt, pts, hand, betas, memory, generator=gen)  # warm-up
    torch.cuda.synchronize()
    del trace[:]
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
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "gpu": gpu, "rows": CLIPS * FOLD, "steps": 10,
          "fired_at": [e["t"] for e in trace],
          "hook_ms": [e["start"].elapsed_time(e["end"]) for e in trace],
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
    from interdiff_torch.ops import group, nn, pointcloud

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_name_and_power()
    phase_build(group, nn, gpu)
    models = full_width_models()
    timed = {"K1": phase_kernels(group, pointcloud, gpu),
             **phase_kernels_nn(nn, models[2], gpu)}
    phase_slice_cpu_vs_gpu(gpu)
    launches = phase_sampler(group, nn, models, gpu)
    phase_profile(models, gpu)

    print(gpu)
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"interdiff_torch/csrc/{source}",
        "replaces": f"interdiff_tpu/ops/{replaces}",
        "launches": launches[key],
        **{k: timed[key][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        **{k: timed[key][k] for k in ("frames", "plain_frames")
           if k in timed[key]}}
        for key, name, source, replaces in (
            ("K1", "K1 ball_group", "ball_group.cu", "pallas_group.py:143"),
            ("K2", "K2 signed_nearest_pruned", "nn.cu", "pallas_nn.py:352"),
            ("K3", "K3 signed_nearest (forward)", "nn.cu",
             "pallas_nn.py:145"),
            ("K4", "K4 nearest_neighbor", "nn.cu", "pallas_nn.py:107"))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
