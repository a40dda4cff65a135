"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure exits non-zero):

1. build: compiles `interdiff_torch/csrc/ball_group.cu` (kernel K1),
   `interdiff_torch/csrc/nn.cu` (K2, K3, K4), `interdiff_torch/csrc/sa.cu`
   (K6) and `interdiff_torch/csrc/gather.cu` (K5) with nvcc, all four at once.
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
   all-far frame.  K5: K1's data with the indices the ball query picks
   there (K = 1024 * 16 and 1024 * 32, int64 and int32), and K = 1,
   repeated indices, C = 3 and C = 8, the last row, -0.0 and out-of-range
   indices (a zero row); beside its time `torch.gather`'s, both also over
   50 launches back to back, and the time of its smallest launch.  K6: K1's
   shape and inputs, both scales with the encoder's chains 4->16->16->32
   (S=16) and 4->32->32->64 (S=32) on seeded weights folded by
   `folded_affine`, and K1's edge rows; beside its time the plain version's
   (5 runs) and, in place of a library call, the unfused route's (K1 +
   `SharedMLP` + `amax`); then the `with_grouped` variant: features bitwise
   equal to the variant without, grouped tensor bitwise equal to K1's output.
3. grads: the `torch.autograd.Function` around each kernel on the card, its
   backward against autograd through the kernel's plain version on the same
   inputs and cotangents: K5, K1 (through K5), K6 (W, a, b, the inputs, and
   the conv and BatchNorm parameters through `folded_affine`), K3 and K4;
   tolerances and their reasons in the line.
4. slice_cpu_vs_gpu: the small sampler (3 layers, d=32, "10" respacing) on
   the card and on the CPU with the same weights and noise, without
   correction (within 1e-5) and with correction in the loop on a 256-vertex
   stand-in body (tolerance and reason in the line; no gate value within
   reach of its threshold, and the same rows corrected on both).  Then the
   small `evaluate` of the eval entry point, with correction, once each for
   the ddpm, ddim and plms samplers: every metric within 1e-4, `penetrate`
   by counts of negative signs, each sign that differs between the devices
   accounted for (sdot near 0, or a tie of the two nearest vertices).  Then
   three train steps of the small model on both devices from the same
   weights, batches, timesteps and noise, on the default route and with
   INTERDIFF_FUSED_SA=1: loss within 1e-5, parameters within the tolerance
   in the line.
5. sampler: the sampler at full width: `MDMSmpl` defaults, 32 clips of 35
   frames with 2048 object points,
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
6. eval: a main path, as `python -m interdiff_torch.cli.eval_smpl_short`
   drives it, at the same width: `evaluate` on one batch of 32 clips, fold
   2, 4 diverse samples (two sampler calls of 1000 DDPM steps with
   correction), gt and sampled FK, `smpl_metrics` with the full sweep: the
   six metrics, the wall time of each part, sampled sequences per second,
   launches K1=2, K2=22, K4=22, K3=2, K5=0, K6=0.  Then one encode and one
   100-step corrected sampler call with INTERDIFF_FUSED_SA=1 (set and
   restored here): K6=2, K1=0, the memory within 1e-4 of the default
   route's, output finite.
7. train: the other main path, `train(...)` of
   `python -m interdiff_torch.cli.train_diffusion_smpl`, at the same width
   (32 clips of 35 frames, 2048 points, AdamW at lr 3e-4, one repeated
   batch): 20 steps on the default route with the EMA shadow on (launches
   per step K1=2, K5=0, K6=0), 20 with INTERDIFF_FUSED_SA=1 (K6=2, K1=0),
   each followed by one validation at "25" respacing and the checkpoints;
   5 steps with `bn_train_mode` (running statistics moved by momentum, out
   of the optimiser); and one encode forward and backward with respect to
   the object cloud (K1's backward replays through K5: K5=2).  Per route:
   the loss of the first and last step, the loss on fixed timesteps and
   noise before and after (it must fall), ms per step by CUDA events and by
   wall, steps/s and sequences/s, the split encode / denoiser forward /
   backward / optimiser, peak memory; the two routes' gradients after the
   first step against each other.
8. profile: a 10-step respaced corrected sampler call at full width (two
   firings) and five full-width train steps under torch.profiler: device
   busy time against wall time.

Then the card's name and power limit (nvidia-smi), the kernel table as one
JSON line (launches: the eval phase's plus the train phase's, each also on
its own; K6's of its opt-in routes, K5's of the backward with respect to the
cloud), and the device line.  Weights and data come from numpy seeds;
no file outside this repository and no network is needed.  The run uses one
card: it sees only device 0 unless CUDA_VISIBLE_DEVICES says otherwise, and
stops if that shows more than one.  A few minutes on an H100.  Depth cut to
fit: the full-sweep sampler path runs 100 respaced steps, the fused-route
sampler call 100, the validations inside the train phase 25.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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
# the encoder's memory through K6 against the default route
FUSED_MEMORY_TOL = 1e-4
FUSED_MEMORY_TOL_REASON = ("K6 folds BatchNorm into a*(x@W)+b and sums the "
                           "products one by one in f32; the default route "
                           "computes (x@W - mean)*mul + bias with a library "
                           "GEMM; both in full f32")
# a sign test n.(a - b) may come out differently on the card and on the CPU
# only below this |sdot|: the sampled states that feed it agree to
# CORRECTED_TOL, and a is a rotated object point of at most 0.21 m plus a
# translation, b a skinned vertex
SIGN_TOL = CORRECTED_TOL
# ... or where the squared distances to the two nearest vertices differ by
# less than this: 2 * d * (error of a + error of b) at d up to 0.5 m
TIE_TOL = 2 * 0.5 * 2 * CORRECTED_TOL
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
# K2-K4, per pair: 3 mul + 2 add (a.b), 1 mul + 1 sub (score), 1 compare
NN_OPS_PER_PAIR = 8
SEED = 233
DEV = "cuda"
# the main path's sizes: 32 clips x 2 diverse samples of 35 frames (10 past,
# 25 future), 2048 object points, the SMPL-H body's 6890 vertices
CLIPS, FOLD, FRAMES, FUTURE, POINTS, VERTS = 32, 2, 35, 25, 2048, 6890
# stage 1 of the encoder: centers, (radius, nsample) and MLP of each scale
CENTERS = 1024
SCALES = ((0.05, 16), (0.1, 32))
STAGE1_MLPS = ((16, 16, 32), (32, 32, 64))


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


def phase_build(group, nn, sa, gather, gpu: str) -> None:
    """The four libraries, one nvcc each, started together."""
    def timed(kernels, module):
        t0 = time.perf_counter()
        path = module.build()
        return {"phase": "build", "gpu": gpu, "kernels": kernels,
                "library": path, "seconds": time.perf_counter() - t0}

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(timed, "K1", group),
                pool.submit(timed, "K2 K3 K4", nn),
                pool.submit(timed, "K6", sa),
                pool.submit(timed, "K5", gather)]
        for job in jobs:
            emit(job.result())


def _edge_rows(group, pointcloud, name: str, kernel, plain) -> dict:
    """``kernel`` against ``plain`` (both called as f(d2t, data, new_xyz,
    radius, S)) on the rows the main-path data rarely has: zero-hit and
    short rows, M not a multiple of the block, and C = 3 (no features).
    Returns the row counts the comparison covered."""
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
            got = kernel(d2t, data, new_xyz, radius, S)
            want = plain(d2t, data, new_xyz, radius, S)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain "
                                     f"version on edge rows, "
                                     f"C={data.shape[-1]}, r={radius}")
            hits = (d2t < pointcloud.radius_sq(radius)).sum(dim=1)
            rows["zero_hit"] += int((hits == 0).sum())
            rows["short"] += int(((hits > 0) & (hits < S)).sum())
            rows["full"] += int((hits >= S).sum())
    if min(rows.values()) == 0:
        raise AssertionError(f"edge check missed a row kind: {rows}")
    return rows


def _stage1_inputs(group, pointcloud):
    """Stage 1 of the encoder at the main-path shape: (data [B, N, 4],
    new_xyz [B, M, 3], d2t [B, N, M]) of 32 seeded ellipsoid clouds."""
    rng = np.random.default_rng(SEED)
    xyz = torch.from_numpy(object_cloud(rng, CLIPS, POINTS)[..., :3]).to(DEV)
    new_xyz = pointcloud.gather_points(
        xyz, pointcloud.hierarchical_fps(xyz, CENTERS, 16)).contiguous()
    data = torch.cat([xyz, torch.linalg.norm(xyz, dim=-1, keepdim=True)],
                     -1).contiguous()
    return data, new_xyz, group.pairwise_sqdist_t(xyz, new_xyz).contiguous()


def _walk_reads(d2t, r2: float, S: int):
    """(reads, hits) [B, M]: the candidates a query's walk reads (up to the
    one that fills its last slot; all N when the row is short) and its
    in-radius candidates."""
    rank = torch.cumsum(d2t < r2, dim=1)  # [B, N, M]
    hits = rank[:, -1]
    reads = torch.where(hits >= S, (rank < S).sum(dim=1) + 1,
                        torch.full_like(hits, d2t.shape[1]))
    return reads, hits


def phase_kernels(group, pointcloud, gpu: str) -> dict:
    """K1 at the main-path shape against its plain version, both scales,
    and on edge rows."""
    data, new_xyz, d2t = _stage1_inputs(group, pointcloud)
    B, N, M = d2t.shape
    scales, total = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "bytes": 0, "ops": 0, "max_abs_err": 0.0}
    for radius, S in SCALES:
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
        reads, hits = _walk_reads(d2t, pointcloud.radius_sq(radius), S)
        n_bytes = int(reads.sum()) * 4 + 4 * (B * N * 4 + B * M * 3
                                              + B * M * S * 4)
        n_ops = int(reads.sum())  # one compare per candidate read
        bound_ms = max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S) * 1e3
        scales.append({
            "radius": radius, "nsample": S, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bytes": n_bytes,
            "full_d2t_bytes": B * N * M * 4, "max_abs_err": err,
            "rows_full": float((hits >= S).float().mean()),
            "rows_zero_hit": float((hits == 0).float().mean()),
            "library_ms": None})
        for k in ("ms", "plain_ms", "bound_ms"):
            total[k] += scales[-1][k]
        total["bytes"] += n_bytes
        total["ops"] += n_ops
        total["max_abs_err"] = max(total["max_abs_err"], err)
    emit({"phase": "kernels", "gpu": gpu, "shape": [B, N, M, 4],
          "bitwise_equal": True, "scales": scales,
          "edge_rows_bitwise_equal": _edge_rows(
              group, pointcloud, "K1", group.group_cuda, group.group_plain)})
    total["library_ms"] = None
    total["bound_by"] = ("bytes" if total["bytes"] / HBM_BYTES_PER_S
                         >= total["ops"] / F32_OPS_PER_S else "operations")
    return total


def phase_kernels_gather(gather, group, pointcloud, gpu: str) -> dict:
    """K5 at K1's shape (the indices the ball query picks there, both
    scales) and on edge rows, bitwise against `gather_rows_plain`; its time
    beside the bound, the plain version, the one PyTorch call
    `torch.gather` and the time of its own smallest launch (the floor)."""
    data, new_xyz, d2t = _stage1_inputs(group, pointcloud)
    B, N, C = data.shape
    scales, total = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "library_ms": 0.0, "max_abs_err": 0.0}
    for radius, S in SCALES:
        idx = pointcloud.ball_query(
            data[..., :3], new_xyz, radius, S,
            d2=d2t.transpose(1, 2)).reshape(B, -1).contiguous()
        got = gather.gather_rows_cuda(data, idx)
        want = gather.gather_rows_plain(data, idx)
        torch.cuda.synchronize()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"K5 differs from its plain version at "
                                 f"S={S}")
        idx32 = idx.to(torch.int32)
        if not torch.equal(gather.gather_rows_cuda(data, idx32), want):
            raise AssertionError(f"K5 differs on int32 indices at S={S}")
        pick = idx[..., None].expand(-1, -1, C)
        n_bytes = idx.numel() * 8 + got.numel() * 4 + data.numel() * 4
        scales.append({
            "nsample": S, "K": idx.shape[1],
            "ms": cuda_ms(lambda: gather.gather_rows_cuda(data, idx)),
            "ms_int32_idx": cuda_ms(
                lambda: gather.gather_rows_cuda(data, idx32)),
            # 50 launches between one pair of events: the larger of the
            # device's time and the host's time per launch
            "ms_back_to_back": cuda_ms(lambda: [
                gather.gather_rows_cuda(data, idx) for _ in range(50)],
                runs=5, warmup=1) / 50,
            "library_ms_back_to_back": cuda_ms(lambda: [
                torch.gather(data, 1, pick) for _ in range(50)],
                runs=5, warmup=1) / 50,
            "plain_ms": cuda_ms(lambda: gather.gather_rows_plain(data, idx)),
            "library_ms": cuda_ms(lambda: torch.gather(data, 1, pick)),
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bytes": n_bytes,
            "max_abs_err": float((got - want).abs().max())})
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            total[k] += scales[-1][k]

    # edge rows: K = 1, repeated indices, C = 3 and C = 8, the last row,
    # -0.0 kept, and indices out of range (a zero row, nothing read)
    rng = np.random.default_rng(SEED + 12)
    edge = {}
    for c in (3, 8):
        d = torch.from_numpy(rng.standard_normal((3, 37, c)).astype(
            np.float32)).to(DEV)
        d[0, 36] = -0.0
        for name, ix in (("k1", [[36], [0], [5]]),
                         ("repeats", [[36, 36, 0, 36, 7] * 9] * 3)):
            ix = torch.tensor(ix, device=DEV)
            got = gather.gather_rows_cuda(d, ix)
            if not torch.equal(got, gather.gather_rows_plain(d, ix)) or \
                    not bool(torch.signbit(got[0, 0]).all()):
                raise AssertionError(f"K5 edge rows: {name}, C={c}")
            edge[f"{name}_c{c}"] = list(got.shape)
        out = gather.gather_rows_cuda(d, torch.tensor(
            [[37, -1, 2 ** 40, 36]] * 3, device=DEV))
        if bool((out[:, :3] != 0).any()) or not torch.equal(out[:, 3],
                                                            d[:, 36]):
            raise AssertionError("K5: an out-of-range index must give a "
                                 "zero row")
    torch.cuda.synchronize()
    one = torch.zeros((1, 1), dtype=torch.int64, device=DEV)
    emit({"phase": "kernels", "gpu": gpu, "kernels": "K5",
          "shape": [B, N, C], "bitwise_equal": True, "scales": scales,
          "launch_floor_ms": cuda_ms(
              lambda: gather.gather_rows_cuda(data[:1], one)),
          "library": "torch.gather(data, 1, idx[..., None].expand(-1, -1, C))",
          "edge_rows_bitwise_equal": edge,
          "out_of_range_index_gives_zero_row": True})
    total["bound_by"] = "bytes"
    return total


def _seeded_shared_mlp(c_in: int, channels, seed: int):
    from interdiff_torch.models.pointnet import SharedMLP

    mlp = SharedMLP(c_in, channels)
    mlp.load_state_dict(seeded_state(mlp, seed), strict=True)
    return mlp.to(DEV).eval()


def phase_kernels_sa(sa, group, pointcloud, gpu: str) -> dict:
    """K6 at the main-path shape (both radius scales of stage 1, seeded
    `SharedMLP` weights folded by `folded_affine`) against `sa_plain`,
    bitwise, and on edge rows; its time beside the plain version's and the
    unfused route's (K1 + `SharedMLP` + `amax`), which stands in for a
    library call: no single PyTorch call computes a scale."""
    data, new_xyz, d2t = _stage1_inputs(group, pointcloud)
    B, N, M = d2t.shape
    C = data.shape[-1]
    scales, total = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "unfused_ms": 0.0, "with_grouped_ms": 0.0,
                         "bytes": 0, "ops": 0, "max_abs_err": 0.0}
    with torch.no_grad():
        for i, ((radius, S), channels) in enumerate(zip(SCALES,
                                                        STAGE1_MLPS)):
            mlp = _seeded_shared_mlp(C, channels, SEED + 8 + i)
            params = sa.folded_affine(mlp)
            got = sa.sa_cuda(d2t, data, new_xyz, params, radius, S)
            want = sa.sa_plain(d2t, data, new_xyz, params, radius, S)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(
                    f"K6 differs from its plain version at r={radius}, "
                    f"S={S}: max abs "
                    f"{float((got - want).abs().max())}")

            # the variant a differentiated forward launches: the same
            # features, and the grouped tensor exactly as K1 writes it
            got_g, grouped = sa.sa_cuda(d2t, data, new_xyz, params, radius,
                                        S, with_grouped=True)
            torch.cuda.synchronize()
            if not torch.equal(got_g, got) or not torch.equal(
                    grouped, group.group_cuda(d2t, data, new_xyz, radius, S)):
                raise AssertionError(
                    f"K6 with_grouped at r={radius}, S={S}: features or "
                    f"grouped tensor differ from K6 / K1")

            def unfused():
                return mlp(group.group_cuda(d2t, data, new_xyz, radius,
                                            S)).amax(dim=2)

            vs_unfused = float((got - unfused()).abs().max())
            ms = cuda_ms(lambda: sa.sa_cuda(d2t, data, new_xyz, params,
                                            radius, S))
            grouped_ms = cuda_ms(lambda: sa.sa_cuda(
                d2t, data, new_xyz, params, radius, S, with_grouped=True))
            plain_ms = cuda_ms(lambda: sa.sa_plain(d2t, data, new_xyz,
                                                   params, radius, S),
                               runs=5, warmup=1)
            unfused_ms = cuda_ms(unfused)
            # what this run's data needs: the walk's reads of d2t, data,
            # centers and weights once, the output once; the chain once per
            # distinct slot of a query (a repeated first hit adds nothing)
            reads, hits = _walk_reads(d2t, pointcloud.radius_sq(radius), S)
            widths = (C,) + tuple(channels)
            macs = sum(a * b for a, b in zip(widths, widths[1:]))
            n_params = macs + 2 * sum(widths[1:])
            slots = int(hits.clamp(min=1, max=S).sum())
            n_bytes = int(reads.sum()) * 4 + 4 * (
                B * N * C + B * M * 3 + n_params + B * M * widths[-1])
            n_ops = 2 * macs * slots
            bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                           n_ops / F32_OPS_PER_S) * 1e3
            scales.append({
                "radius": radius, "nsample": S, "widths": list(widths),
                "ms": ms, "with_grouped_ms": grouped_ms,
                "with_grouped_equals_k6_and_k1": True,
                "plain_ms": plain_ms, "unfused_ms": unfused_ms,
                "bound_ms": bound_ms, "bytes": n_bytes, "ops": n_ops,
                "ops_all_slots": 2 * macs * S * M * B,
                "distinct_slots_mean": slots / (B * M),
                "max_abs_err": float((got - want).abs().max()),
                "max_abs_diff_vs_unfused": vs_unfused})
            for k in ("ms", "with_grouped_ms", "plain_ms", "unfused_ms",
                      "bound_ms", "bytes", "ops"):
                total[k] += scales[-1][k]

        def edge_params(c):
            return sa.folded_affine(_seeded_shared_mlp(c, (8, 8, 16),
                                                       SEED + 10))

        edge = _edge_rows(
            group, pointcloud, "K6",
            lambda d, x, c, r, S: sa.sa_cuda(d, x, c, edge_params(
                x.shape[-1]), r, S),
            lambda d, x, c, r, S: sa.sa_plain(d, x, c, edge_params(
                x.shape[-1]), r, S))

        def both(fn):  # features and grouped tensor as one tensor
            return lambda d, x, c, r, S: torch.cat([t.flatten() for t in fn(
                d, x, c, edge_params(x.shape[-1]), r, S, with_grouped=True)])

        _edge_rows(group, pointcloud, "K6 with_grouped", both(sa.sa_cuda),
                   both(sa.sa_plain))
    emit({"phase": "kernels", "gpu": gpu, "kernels": "K6",
          "shape": [B, N, M, C], "bitwise_equal": True, "scales": scales,
          "edge_rows_bitwise_equal": edge})
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


# a Function's backward against autograd through the kernel's plain version,
# relative to the largest entry of the gradient.  K1, K3, K4, K5: the same
# gathers and sums in another order (scatter-adds are atomic adds on the
# card), a few float32 roundings.  K6: the backward multiplies with a library
# GEMM where the plain version sums product by product, both in full float32
# (its weight gradients are sums of a million float32 products)
GRAD_TOL = {"K1": 1e-5, "K3": 1e-5, "K4": 1e-5, "K5": 1e-5, "K6": 1e-3}
# K6's input cotangent is sparse: each (query, channel) sends its cotangent
# to the slot that holds the maximum.  Where two neighbours' outputs lie
# within a rounding of each other, the GEMM of the backward and the sums of
# the plain version pick different ones, and a few entries of the gradient
# move by a whole contribution: at most this share of them may
K6_FLIP_SHARE = 1e-3


def _grad_errs(name: str, got, want, labels, flips=()) -> dict:
    """Relative max error per gradient; raises beyond GRAD_TOL[name], or,
    for a label in ``flips``, when more than K6_FLIP_SHARE of the entries
    lie beyond it."""
    errs = {}
    for label, g, w in zip(labels, got, want):
        rel = (g - w).abs() / w.abs().max().clamp(min=1e-30)
        errs[label] = float(rel.max())
        ok = errs[label] <= GRAD_TOL[name]
        if label in flips:
            share = float((rel > GRAD_TOL[name]).float().mean())
            errs[f"{label}_share_beyond_tolerance"] = share
            ok = share <= K6_FLIP_SHARE
        if not ok or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: gradient of {label} is "
                                 f"{errs[label]} from its plain version's "
                                 f"(tolerance {GRAD_TOL[name]})")
    return errs


def phase_grads(gather, group, sa, nn, pointcloud, body, gpu: str) -> None:
    """Each `torch.autograd.Function` of the kernels on the card: its
    backward against autograd through the kernel's plain version, on the
    same inputs and cotangents.  K5 and K1 at stage 1's shape (K1 with
    respect to xyz, new_xyz and the features; its backward goes through
    K5), K6 at stage 1's shape with respect to W, a, b and the inputs, and
    with respect to the conv and BatchNorm parameters through
    `folded_affine`; K3 and K4 with respect to a, b, n on 16 frames of the
    posed body.  Also the spread of two runs of one backward (atomic adds)."""
    from interdiff_torch.ops import signed_distance

    def leaves(*tensors):
        return [t.detach().clone().requires_grad_(True) for t in tensors]

    def grads_of(outputs, cotangents, wrt):
        return torch.autograd.grad(outputs, wrt, cotangents)

    data, new_xyz, d2t = _stage1_inputs(group, pointcloud)
    xyz, feats = data[..., :3].contiguous(), data[..., 3:].contiguous()
    rng = np.random.default_rng(SEED + 13)
    radius, S = SCALES[1]
    out = {"phase": "grads", "gpu": gpu, "tolerance": GRAD_TOL,
           "tolerance_reason": "relative to the gradient's largest entry; "
           "order of the atomic adds in the scatter-adds and a few float32 "
           "roundings (K1, K3, K4, K5); a library GEMM in the backward "
           "against sums product by product in the plain version (K6; its "
           "input cotangent by the share of entries beyond the tolerance, "
           "near-ties of the maximum over neighbours)"}

    # K5
    idx = pointcloud.ball_query(xyz, new_xyz, radius, S,
                                d2=d2t.transpose(1, 2)).reshape(
                                    xyz.shape[0], -1)
    g = torch.from_numpy(rng.standard_normal(
        (idx.shape[0], idx.shape[1], 4)).astype(np.float32)).to(DEV)
    d1, d2 = leaves(data, data)
    before = gather.launches
    got = grads_of(gather.gather_rows(d1, idx), g, [d1])
    again = grads_of(gather.gather_rows(d1, idx), g, [d1])
    if gather.launches != before + 2:
        raise AssertionError("gather_rows did not launch K5")
    want = grads_of(gather.gather_rows_plain(d2, idx), g, [d2])
    out["K5"] = _grad_errs("K5", got, want, ["data"])
    out["K5"]["two_runs_max_abs_diff"] = float(
        (got[0] - again[0]).abs().max())
    out["K5"]["largest_gradient"] = float(want[0].abs().max())

    # K1: backward by replay through K5
    g = torch.from_numpy(rng.standard_normal(
        (xyz.shape[0], new_xyz.shape[1], S, 4)).astype(np.float32)).to(DEV)
    a = leaves(xyz, new_xyz, feats)
    b = leaves(xyz, new_xyz, feats)
    k1, k5 = group.launches, gather.launches
    got = grads_of(group.fused_query_group(*a, radius, S, d2t), g, a)
    if group.launches != k1 + 1 or gather.launches != k5 + 1:
        raise AssertionError("K1's backward did not replay through K5")
    k5 = gather.launches
    want = grads_of(group.group_plain(
        d2t, torch.cat([b[0], b[2]], -1), b[1], radius, S), g, b)
    if gather.launches != k5:
        raise AssertionError("K5 ran inside K1's plain version")
    out["K1"] = _grad_errs("K1", got, want, ["xyz", "new_xyz", "features"])

    # K6: W, a, b and the inputs as leaves, then through folded_affine
    mlp = _seeded_shared_mlp(4, STAGE1_MLPS[1], SEED + 9)
    mlp2 = _seeded_shared_mlp(4, STAGE1_MLPS[1], SEED + 9)
    with torch.no_grad():
        flat = [t for layer in sa.folded_affine(mlp) for t in layer]
    g = torch.from_numpy(rng.standard_normal(
        (xyz.shape[0], new_xyz.shape[1], STAGE1_MLPS[1][-1])).astype(
            np.float32)).to(DEV)

    def layers(ts):
        return tuple(zip(ts[0::3], ts[1::3], ts[2::3]))

    a, b = leaves(xyz, new_xyz, feats, *flat), leaves(xyz, new_xyz, feats,
                                                     *flat)
    k6, k1, k5 = sa.launches, group.launches, gather.launches
    got = grads_of(sa.fused_sa_scale(*a[:3], layers(a[3:]), radius, S, d2t),
                   g, a)
    if (sa.launches, group.launches, gather.launches) != (k6 + 1, k1 + 1,
                                                          k5 + 1):
        raise AssertionError("K6's backward: expected one K6 launch and the "
                             "input cotangent through K1 and K5")
    k5 = gather.launches
    want = grads_of(sa.sa_plain(d2t, torch.cat([b[0], b[2]], -1), b[1],
                                layers(b[3:]), radius, S), g, b)
    if gather.launches != k5:
        raise AssertionError("K5 ran inside K6's plain version")
    labels = ["xyz", "new_xyz", "features"] + [
        f"{n}{i}" for i in range(len(flat) // 3) for n in "Wab"]
    out["K6"] = _grad_errs("K6", got, want, labels, flips=labels[:3])
    out["K6"]["flip_share_allowed"] = K6_FLIP_SHARE
    # both float32 gradients of W, a, b beside a float64 one (the chain and
    # the maximum over K1's grouped tensor in float64)
    c = [t.double().requires_grad_(True) for t in flat]
    ref = grads_of(sa._mlp_max(group.group_cuda(
        d2t, data, new_xyz, radius, S).double(), layers(c)), g.double(), c)
    for side, grads in (("function", got[3:]), ("plain", want[3:])):
        out["K6"][f"{side}_vs_float64"] = max(
            float((x - r).abs().max() / r.abs().max())
            for x, r in zip(grads, ref))
    names = [n for n, _ in mlp.named_parameters()]
    k6, k1 = sa.launches, group.launches
    got = grads_of(sa.fused_sa_scale(xyz, new_xyz, feats,
                                     sa.folded_affine(mlp), radius, S, d2t),
                   g, list(mlp.parameters()))
    if (sa.launches, group.launches) != (k6 + 1, k1):
        raise AssertionError("a parameter-only K6 backward must not replay "
                             "the grouping")
    want = grads_of(sa.sa_plain(d2t, data, new_xyz, sa.folded_affine(mlp2),
                                radius, S), g, list(mlp2.parameters()))
    out["K6"].update(_grad_errs("K6", got, want, names))

    # K3 and K4 on 16 frames of the posed body
    verts, normals, cloud = _nn_geometry(rng, 16, POINTS, body)
    g_sq, g_sd = (torch.from_numpy(rng.standard_normal(
        (16, POINTS)).astype(np.float32)).to(DEV) for _ in range(2))
    a, b = leaves(cloud, verts, normals), leaves(cloud, verts, normals)
    k3 = nn.launches["signed_nearest"]
    got = grads_of(signed_distance.signed_nearest(*a), (g_sq, g_sd), a)
    if nn.launches["signed_nearest"] != k3 + 1:
        raise AssertionError("signed_nearest did not launch K3")
    want = grads_of(nn.signed_nearest_plain(*b)[:2], (g_sq, g_sd), b)
    out["K3"] = _grad_errs("K3", got, want, ["a", "b", "n"])
    a, b = leaves(verts[:, :67], cloud), leaves(verts[:, :67], cloud)
    g_sq = g_sq[:, :67].contiguous()
    k4 = nn.launches["nearest_neighbor"]
    got = grads_of(signed_distance.nearest_neighbor(*a)[0], g_sq, a)
    if nn.launches["nearest_neighbor"] != k4 + 1:
        raise AssertionError("nearest_neighbor did not launch K4")
    want = grads_of(nn.nearest_neighbor_plain(*b)[0], g_sq, b)
    out["K4"] = _grad_errs("K4", got, want, ["a", "b"])
    torch.cuda.synchronize()
    emit(out)


SMALL = dict(embedding_dim=32, num_heads=4, ff_size=64, num_layers=3)
SMALL_MARKERS = np.arange(40)


@torch.no_grad()
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


def _small_evaluate(device, sampler: str, state, projector_state, batch,
                    noises):
    """The small `evaluate` on ``device``: 2 clips, fold 2, 2 diverse
    samples, "10" respacing, correction in the loop on the 256-vertex
    stand-in body, full-sweep `penetrate`.  Returns (totals, the metric
    sweep's (queries, vertices, sdot) per call)."""
    from interdiff_torch.cli.eval_smpl_short import evaluate
    from interdiff_torch.config import (
        CorrectionConfig,
        DiffusionConfig,
        SmplTrackConfig,
        build_smpl_body,
    )
    from interdiff_torch.eval import metrics as metrics_mod
    from interdiff_torch.eval.smpl_short import SmplEvalConfig

    track = SmplTrackConfig(**SMALL,
                            diffusion=DiffusionConfig(timestep_respacing="10"))
    model = track.build_model(device)
    model.load_state_dict(state, strict=True)
    projector = CorrectionConfig(num_nodes=40, dct=4).build_model(device)
    projector.load_state_dict(projector_state, strict=True)
    body = build_smpl_body(seed=SEED, num_verts=256, device=device)
    sdots, sweep = [], metrics_mod.signed_nearest

    def recording_sweep(a, b, n, **kwargs):
        out = sweep(a, b, n, **kwargs)
        sdots.append((a, b, out[1]))
        return out

    metrics_mod.signed_nearest = recording_sweep
    try:
        totals, _ = evaluate(
            SmplEvalConfig(correction_t_max=9, correction_every=3), model,
            track.diffusion.build(device), body, [batch],
            projector=projector, diverse_samples=2, diverse_fold=2,
            sampler=sampler, markers_idx=SMALL_MARKERS,
            noises=iter([tuple(t.to(device) for t in pair)
                         for pair in noises]),
            report=lambda nb, means: None)
    finally:
        metrics_mod.signed_nearest = sweep
    return totals, sdots


def phase_slice_eval_cpu_vs_gpu(gpu: str) -> None:
    """The small `evaluate` on the card against the CPU, same weights and
    noise, once per sampler: every metric within 1e-4; `penetrate` (a mean
    of sign tests) by counts, which may differ only by signs whose sdot lies
    within SIGN_TOL of 0 on one of the devices or whose two nearest
    vertices are equidistant within TIE_TOL."""
    from interdiff_torch.config import CorrectionConfig, SmplTrackConfig

    rng = np.random.default_rng(36)
    B, T, P = 2, 35, 64
    batch = {k: np.float32(scale) * rng.standard_normal(shape).astype(
        np.float32) for k, shape, scale in (
            ("body_pose", (B, T, 156), 0.3), ("body_trans", (B, T, 3), 0.2),
            ("obj_angles", (B, T, 3), 1.0), ("obj_trans", (B, T, 3), 0.2),
            ("body_betas", (B, T, 10), 0.5))}
    batch["obj_points"] = rng.uniform(-0.12, 0.12, (B, P, 6)).astype(
        np.float32)
    xyz = batch["obj_points"][..., :3].astype(np.float64)
    d2 = ((xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
    margin = min(float(np.abs(d2 - np.float32(r * r)).min())
                 for r in (0.05, 0.1, 0.2))
    if margin <= 1e-6:  # a pair on a radius could flip between devices
        raise AssertionError(f"cloud has a pair {margin} from a radius")
    noises = [(torch.from_numpy(rng.standard_normal(
        (2 * B, T, 144)).astype(np.float32)), torch.from_numpy(
            rng.standard_normal((10, 2 * B, T, 144)).astype(np.float32)))]
    state = seeded_state(SmplTrackConfig(**SMALL).build_model("cpu"), SEED)
    projector_state = seeded_state(
        CorrectionConfig(num_nodes=40, dct=4).build_model("cpu"), SEED + 6)
    tol, signs = 1e-4, B * (T - 10) * P  # sign tests behind one penetrate
    for sampler in ("ddpm", "ddim", "plms"):
        cpu, sdots_cpu = _small_evaluate("cpu", sampler, state,
                                         projector_state, batch, noises)
        cuda, sdots = _small_evaluate(DEV, sampler, state, projector_state,
                                      batch, noises)
        sdot_cpu = torch.cat([s[2] for s in sdots_cpu]).flatten()
        a, b, sdot = (torch.cat([s[i] for s in sdots]).cpu()
                      for i in range(3))
        sdot = sdot.flatten()
        least = torch.minimum(sdot_cpu.abs(), sdot.abs())
        flipped = (sdot_cpu < 0) != (sdot < 0)
        # a sign may differ between the devices where sdot lies within
        # their difference of 0, or where the two nearest vertices are so
        # nearly equidistant that the devices pick different ones
        unexplained, ties = 0, []
        for flat in flipped.nonzero().flatten().tolist():
            frame, q = divmod(flat, a.shape[1])
            d2 = ((b[frame].double() - a[frame, q].double()) ** 2).sum(-1)
            first, second = torch.topk(d2, 2, largest=False).values.tolist()
            ties.append(second - first)
            if least[flat] >= SIGN_TOL and second - first >= TIE_TOL:
                unexplained += 1
        # totals["penetrate"] is the mean over B clips of counts / (Tf * P)
        counts = {dev: round(m["penetrate"] * signs)
                  for dev, m in (("cpu", cpu), ("cuda", cuda))}
        errs = {k: abs(cpu[k] - cuda[k]) for k in cpu if k != "penetrate"}
        emit({"phase": "slice_cpu_vs_gpu", "gpu": gpu, "entry": "evaluate",
              "sampler": sampler, "clips": B, "diverse_samples": 2,
              "steps": 10, "metrics_cuda": cuda, "max_abs_err": errs,
              "tolerance": tol, "tolerance_reason": CORRECTED_TOL_REASON,
              "penetrate_counts": counts, "sign_tests": signs,
              "sign_tests_swept": sdot.numel(),
              "sdot_within_1e-6_of_0": int((sdot.abs() < 1e-6).sum()),
              "sdot_within_tolerance_of_0": int(
                  (sdot.abs() < SIGN_TOL).sum()),
              "signs_flipped": int(flipped.sum()),
              "flipped_sdot_least_abs": least[flipped].tolist(),
              "flipped_gap_of_two_nearest_vertices_m2": ties,
              "sign_tolerance": SIGN_TOL, "tie_tolerance_m2": TIE_TOL})
        if not max(errs.values()) <= tol:
            raise AssertionError(f"evaluate({sampler}): card vs CPU differ "
                                 f"by {errs}")
        if unexplained or \
                abs(counts["cpu"] - counts["cuda"]) > int(flipped.sum()):
            raise AssertionError(f"evaluate({sampler}): penetrate counts "
                                 f"{counts}, {int(flipped.sum())} signs "
                                 f"flipped, {unexplained} of them neither "
                                 f"near 0 nor at a tie of the nearest vertex")


def _main_path_batch(rng, B, T, P) -> dict:
    """One raw batch in the layout of the eval entry point's loader: seeded
    poses and ellipsoid object clouds."""
    pose, trans, obj_angles, obj_trans = (
        rng.standard_normal((B, T, 66)) * 0.4,
        rng.standard_normal((B, T, 3)) * 0.5,
        rng.standard_normal((B, T, 3)),
        rng.standard_normal((B, T, 3)) * 0.5)
    pts = object_cloud(rng, B, P)
    hand = rng.standard_normal((B, T, 90)) * 0.1
    betas = np.broadcast_to(rng.standard_normal((B, 1, 10)) * 0.5, (B, T, 10))
    batch = {"body_pose": np.concatenate([pose, hand], -1),
             "body_trans": trans, "obj_angles": obj_angles,
             "obj_trans": obj_trans, "obj_points": pts, "body_betas": betas}
    return {k: np.ascontiguousarray(v, dtype=np.float32)
            for k, v in batch.items()}


def _main_path_inputs(rng, B, T, P, device):
    from interdiff_torch.models.mdm_smpl import smpl_gt_from_raw

    b = {k: torch.from_numpy(v).to(device)
         for k, v in _main_path_batch(rng, B, T, P).items()}
    gt = smpl_gt_from_raw(b["body_pose"][..., :66], b["body_trans"],
                          b["obj_angles"], b["obj_trans"])
    return gt, b["obj_points"], b["body_pose"][..., 66:], b["body_betas"]


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


def _reset_launches(group, nn, sa) -> None:
    from interdiff_torch.ops import gather

    group.launches = 0
    gather.launches = 0
    sa.launches = 0
    for name in nn.launches:
        nn.launches[name] = 0


def _read_launches(group, nn, sa) -> dict:
    return {"K1": group.launches, "K2": nn.launches["signed_nearest_pruned"],
            "K3": nn.launches["signed_nearest"],
            "K4": nn.launches["nearest_neighbor"],
            "K5": sys.modules["interdiff_torch.ops.gather"].launches,
            "K6": sa.launches}


def _check_sample(x, gt, cfg, past_channels: int) -> None:
    if tuple(x.shape) != tuple(gt.shape) or not bool(
            torch.isfinite(x).all()):
        raise AssertionError(f"bad sample: shape {tuple(x.shape)}")
    if not torch.equal(x[:, :cfg.past_len, :past_channels],
                       gt[:, :cfg.past_len, :past_channels]):
        raise AssertionError("past frames differ from gt")


@torch.no_grad()
def phase_sampler(group, nn, sa, models, gpu: str) -> dict:
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
        _reset_launches(group, nn, sa)
        t0 = time.perf_counter()
        memory = model.encode(gt, pts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tiled = tile_for_diverse_samples((gt, pts, hand, betas, memory), fold)
        x = run(*tiled, generator=gen)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = _read_launches(group, nn, sa)
    finally:
        nn.segment_flags = segment_flags
    if launches != {"K1": 2, "K2": 11, "K3": 0, "K4": 11, "K5": 0, "K6": 0}:
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
    _reset_launches(group, nn, sa)
    t0 = time.perf_counter()
    x = run_full(*tiled, generator=gen)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches_full = _read_launches(group, nn, sa)
    if launches_full != {"K1": 0, "K2": 0, "K3": 2, "K4": 2, "K5": 0, "K6": 0}:
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
    _reset_launches(group, nn, sa)
    t0 = time.perf_counter()
    memory = model.encode(gt, pts)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tiled = tile_for_diverse_samples((gt, pts, hand, betas, memory), fold)
    x = plain(*tiled, generator=gen)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches_plain = _read_launches(group, nn, sa)
    if launches_plain != {"K1": 2, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0}:
        raise AssertionError(f"launches without correction: "
                             f"{launches_plain}")
    _check_sample(x, tiled[0], cfg, 144)
    emit({**common, "path": "no correction", "steps": steps,
          "encode_ms": (t1 - t0) * 1e3, "sampler_ms": (t2 - t1) * 1e3,
          "seq_per_s": rows / (t2 - t0),
          "ms_per_step": (t2 - t1) * 1e3 / steps,
          "launches": launches_plain})
    return {**launches, "K3": launches_full["K3"]}


@torch.no_grad()
def phase_eval(group, nn, sa, models, gpu: str) -> dict:
    """The eval entry point's loop at full width: `evaluate` on one batch of
    32 clips, fold 2, 4 diverse samples (two 1000-step sampler calls of 64
    rows with correction in the loop), `smpl_metrics` with the full sweep
    (K3).  Then the opt-in route of the encoder: one encode and one 100-step
    corrected sampler call with INTERDIFF_FUSED_SA=1 (K6 instead of K1).
    Returns the launches of each kernel on the path that runs it."""
    from interdiff_torch.cli.eval_smpl_short import evaluate
    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.eval.smpl_short import SmplEvalConfig, make_sampler
    from interdiff_torch.parallel.sample_parallel import (
        tile_for_diverse_samples,
    )

    rng = np.random.default_rng(SEED + 11)
    model, projector, body = models
    cfg, diffusion = SmplEvalConfig(), DiffusionConfig().build()
    batch = _main_path_batch(rng, CLIPS, FRAMES, POINTS)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    samples, timings, running = 2 * FOLD, {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(group, nn, sa)
    t0 = time.perf_counter()
    totals, batches = evaluate(
        cfg, model, diffusion, body, [batch], projector=projector,
        diverse_samples=samples, diverse_fold=FOLD, generator=gen,
        timings=timings, report=lambda nb, means: running.append(means))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches(group, nn, sa)
    if launches != {"K1": 2, "K2": 22, "K3": 2, "K4": 22, "K5": 0, "K6": 0}:
        raise AssertionError(f"launches of the eval loop: {launches}")
    keys = {"global_mpjpe", "local_mpjpe", "body_translation",
            "obj_translation", "obj_rot_error", "penetrate"}
    if batches != 1 or set(totals) != keys or running != [totals] \
            or not all(np.isfinite(v) and v >= 0 for v in totals.values()) \
            or not 0.0 < totals["penetrate"] < 1.0:
        raise AssertionError(f"bad metrics: {totals} over {batches} batches")
    emit({"phase": "eval", "gpu": gpu, "clips": CLIPS, "fold": FOLD,
          "diverse_samples": samples, "frames": FRAMES, "points": POINTS,
          "verts": VERTS, "steps": diffusion.num_timesteps,
          "metrics": totals, "wall_s": wall,
          "part_s": timings, "part_share": {k: v / wall
                                            for k, v in timings.items()},
          "seq_per_s": CLIPS * samples / wall, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})

    # -- the encoder's opt-in route through K6
    gt, pts, hand, betas = _main_path_inputs(
        np.random.default_rng(SEED + 11), CLIPS, FRAMES, POINTS, DEV)
    short = DiffusionConfig(timestep_respacing="100").build()
    run = make_sampler(cfg, model, short, smpl=body, projector=projector,
                       use_correction=True, reuse_memory=True)

    def encode_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        memory = model.encode(gt, pts)
        torch.cuda.synchronize()
        return memory, (time.perf_counter() - t0) * 1e3

    model.encode(gt, pts)  # warm-up of both timed encodes
    memory_unfused, unfused_ms = encode_ms()
    with _fused_route(True):
        _reset_launches(group, nn, sa)
        memory, fused_ms = encode_ms()
        tiled = tile_for_diverse_samples((gt, pts, hand, betas, memory), FOLD)
        x = run(*tiled, generator=gen)
        torch.cuda.synchronize()
        launches_fused = _read_launches(group, nn, sa)
    if launches_fused != {"K1": 0, "K2": 2, "K3": 0, "K4": 2, "K5": 0, "K6": 2}:
        raise AssertionError(f"launches on the fused route: {launches_fused}")
    _check_sample(x, tiled[0], cfg, 135)
    err = float((memory - memory_unfused).abs().max())
    emit({"phase": "eval", "gpu": gpu, "path": "INTERDIFF_FUSED_SA=1",
          "steps": short.num_timesteps, "launches": launches_fused,
          "encode_ms_fused": fused_ms, "encode_ms_unfused": unfused_ms,
          "memory_max_abs_diff_vs_unfused": err,
          "tolerance": FUSED_MEMORY_TOL,
          "tolerance_reason": FUSED_MEMORY_TOL_REASON})
    if not err <= FUSED_MEMORY_TOL:
        raise AssertionError(f"fused encode differs from the unfused by "
                             f"{err} > {FUSED_MEMORY_TOL}")
    return {**launches, "K6": launches_fused["K6"]}


@contextlib.contextmanager
def _fused_route(on: bool):
    """INTERDIFF_FUSED_SA set (or unset) inside the block, restored after."""
    before = os.environ.pop("INTERDIFF_FUSED_SA", None)
    if on:
        os.environ["INTERDIFF_FUSED_SA"] = "1"
    try:
        yield
    finally:
        os.environ.pop("INTERDIFF_FUSED_SA", None)
        if before is not None:
            os.environ["INTERDIFF_FUSED_SA"] = before


TRAIN_KEYS = ("body_pose", "body_trans", "obj_angles", "obj_trans",
              "obj_points")
TRAIN_LR = 3e-4


def _small_train_run(device, state, batches, ts, noises):
    """Three steps of `make_smpl_train_step` on the small model on
    ``device`` with the given timesteps and noise; returns (the losses,
    the state dict after the steps, on the CPU)."""
    from interdiff_torch.config import SmplTrackConfig
    from interdiff_torch.train import trainer

    track = SmplTrackConfig(**SMALL)
    model = track.build_model(device)
    model.load_state_dict(state, strict=True)
    step = trainer.make_smpl_train_step(model, track.diffusion.build(device))
    train_state = trainer.TrainState.create(
        dict(model.named_parameters()), trainer.adamw(TRAIN_LR))
    losses = []
    for batch, t, noise in zip(batches, ts, noises):
        train_state, metrics = step(
            train_state, {k: torch.from_numpy(batch[k]).to(device)
                          for k in TRAIN_KEYS},
            t=torch.from_numpy(t).to(device), noise=torch.from_numpy(
                noise).to(device))
        losses.append(float(metrics["loss"]))
    return losses, {k: v.detach().cpu() for k, v in
                    model.state_dict().items()}


def phase_slice_train_cpu_vs_gpu(group, sa, gpu: str) -> None:
    """Three train steps of the small model on the card against the CPU,
    from the same weights, batches, timesteps and noise, on the default
    route and with INTERDIFF_FUSED_SA=1: the loss of every step within 1e-5;
    the parameters within 2 * steps * lr everywhere (Adam turns a gradient
    that is rounding noise into a step of up to lr, in either direction) and
    within lr / 100 on average."""
    from interdiff_torch.config import SmplTrackConfig

    rng = np.random.default_rng(37)
    B, T, P, steps = 2, 35, 64, 3
    batches = []
    for _ in range(steps):
        margin = 0.0
        while margin <= 1e-6:  # a pair on a radius could flip between devices
            pts = rng.uniform(-0.12, 0.12, (B, P, 6)).astype(np.float32)
            xyz = pts[..., :3].astype(np.float64)
            d2 = ((xyz[:, :, None] - xyz[:, None]) ** 2).sum(-1)
            margin = min(float(np.abs(d2 - np.float32(r * r)).min())
                         for r in (0.05, 0.1, 0.2))
        batches.append({
            "body_pose": (rng.standard_normal((B, T, 156)) * 0.3).astype(
                np.float32),
            "obj_points": pts,
            **{k: rng.standard_normal((B, T, 3)).astype(np.float32)
               for k in ("body_trans", "obj_angles", "obj_trans")}})
    ts = rng.integers(0, 1000, (steps, B))
    noises = rng.standard_normal((steps, B, T, 144)).astype(np.float32)
    state = seeded_state(SmplTrackConfig(**SMALL).build_model("cpu"), SEED)
    for fused in (False, True):
        with _fused_route(fused):
            cpu_losses, cpu = _small_train_run("cpu", state, batches, ts,
                                               noises)
            k1, k6 = group.launches, sa.launches
            cuda_losses, cuda = _small_train_run(DEV, state, batches, ts,
                                                 noises)
            launched = {"K1": group.launches - k1, "K6": sa.launches - k6}
        want = {"K1": 0, "K6": 2 * steps} if fused else {"K1": 2 * steps,
                                                         "K6": 0}
        diffs = torch.cat([(cpu[k] - cuda[k]).abs().flatten() for k in cpu])
        moved = max(float((cuda[k] - state[k]).abs().max()) for k in cpu)
        loss_err = max(abs(a - b) for a, b in zip(cpu_losses, cuda_losses))
        emit({"phase": "slice_cpu_vs_gpu", "gpu": gpu, "entry": "train step",
              "route": "INTERDIFF_FUSED_SA=1" if fused else "default",
              "steps": steps, "lr": TRAIN_LR, "losses_cuda": cuda_losses,
              "loss_max_abs_err": loss_err, "loss_tolerance": 1e-5,
              "param_max_abs_diff": float(diffs.max()),
              "param_tolerance": 2 * steps * TRAIN_LR,
              "param_mean_abs_diff": float(diffs.mean()),
              "param_mean_tolerance": TRAIN_LR / 100,
              "largest_parameter_move": moved, "launches": launched,
              "tolerance_reason": "summation order of the card's kernels, "
              "full f32; Adam normalises a gradient that is rounding noise "
              "into a step of up to lr"})
        if launched != want:
            raise AssertionError(f"small train steps launched {launched}")
        if not (loss_err <= 1e-5 and float(diffs.max()) <= 2 * steps
                * TRAIN_LR and float(diffs.mean()) <= TRAIN_LR / 100
                and moved > TRAIN_LR):
            raise AssertionError("train steps: card vs CPU out of tolerance")


TRAIN_STEPS = 20
# the two routes' gradients after the first step, each tensor relative to
# its largest entry.  Stage 1's own tensors are sums of about a million
# products per weight, taken one by one in K6's backward replay and by
# library GEMMs on the default route (each is about 3e-4 from a float64 sum
# on random cotangents, see the grads phase, and 9.5e-4 apart on a train
# step's, which cancel more); everything downstream sees only the 1e-7
# difference of the two forwards
ROUTE_GRAD_TOL = {"pcEmbedding.sa0": 5e-3, "": 1e-4}


def _train_model(seed: int = SEED + 1):
    from interdiff_torch.config import SmplTrackConfig

    model = SmplTrackConfig().build_model()
    model.load_state_dict(seeded_state(model, seed), strict=True)
    return model


def _fixed_draw_loss(model, diffusion, batch) -> float:
    """The training loss of ``batch`` on fixed timesteps and noise."""
    from interdiff_torch.train import trainer
    from interdiff_torch.train.losses import smpl_diffusion_losses

    gen = torch.Generator(device=DEV).manual_seed(SEED + 21)
    with torch.no_grad():
        gt, pts = trainer.smpl_cond_inputs(batch)
        memory = model.encode(gt, pts)
        t = torch.arange(gt.shape[0], device=DEV) * (
            diffusion.num_timesteps // gt.shape[0])
        noise = torch.randn(gt.shape, generator=gen, device=DEV)
        pred, target = diffusion.training_losses(
            lambda x, ts: model.denoise(x, ts, memory), gt, t, noise=noise)
        return float(smpl_diffusion_losses(
            pred, target, past_len=model.past_len)[0].mean())


def _step_split(model, diffusion, batch, runs: int = 5) -> dict:
    """Median ms of the parts of one train step, built from the package's
    own pieces: encode, denoiser forward with the loss, backward, AdamW;
    by CUDA events and, with a synchronisation after each part, by wall."""
    from interdiff_torch.train import trainer
    from interdiff_torch.train.losses import smpl_diffusion_losses

    opt = trainer.adamw(TRAIN_LR)(list(model.parameters()))
    gen = torch.Generator(device=DEV).manual_seed(SEED + 22)
    parts = ("encode", "denoiser_forward_and_loss", "backward", "optimiser")
    ev_ms, wall_ms = {p: [] for p in parts}, {p: [] for p in parts}
    for run in range(runs + 1):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        walls = []

        def mark(i):
            marks[i].record()
            torch.cuda.synchronize()
            walls.append(time.perf_counter())

        mark(0)
        gt, pts = trainer.smpl_cond_inputs(batch)
        memory = model.encode(gt, pts)
        mark(1)
        t, _ = trainer.sample_timesteps(gen, gt.shape[0],
                                        diffusion.num_timesteps, DEV)
        noise = torch.randn(gt.shape, generator=gen, device=DEV)
        pred, target = diffusion.training_losses(
            lambda x, ts: model.denoise(x, ts, memory), gt, t, noise=noise)
        loss = smpl_diffusion_losses(pred, target,
                                     past_len=model.past_len)[0].mean()
        mark(2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        mark(3)
        opt.step()
        mark(4)
        if run == 0:
            continue  # warm-up
        for i, p in enumerate(parts):
            ev_ms[p].append(marks[i].elapsed_time(marks[i + 1]))
            wall_ms[p].append((walls[i + 1] - walls[i]) * 1e3)
    return {"cuda_events_ms": {p: statistics.median(v)
                               for p, v in ev_ms.items()},
            "wall_ms_synchronised": {p: statistics.median(v)
                                     for p, v in wall_ms.items()}}


def phase_train(group, nn, sa, gather, gpu: str) -> dict:
    """The training entry point's loop, `train(...)` of
    `cli/train_diffusion_smpl.py`, at full width: `MDMSmpl` defaults, 32
    clips of 35 frames with 2048 object points a step, AdamW at lr 3e-4.
    20 steps on the default route with the EMA shadow on, 20 with
    INTERDIFF_FUSED_SA=1, each followed by one validation at "25"
    respacing; 5 steps with bn_train_mode; one forward and backward that
    also asks for the gradient with respect to the object cloud (K1's
    backward replays through K5).  Returns the kernels' launches."""
    import tempfile

    from interdiff_torch.cli.train_diffusion_smpl import train
    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.train import trainer

    rng = np.random.default_rng(SEED + 20)
    batch = _main_path_batch(rng, CLIPS, FRAMES, POINTS)
    on_card = {k: torch.from_numpy(batch[k]).to(DEV) for k in TRAIN_KEYS}
    diffusion = DiffusionConfig().build()
    val_diffusion = DiffusionConfig(timestep_respacing="25").build()
    common = {"phase": "train", "gpu": gpu, "clips": CLIPS, "frames": FRAMES,
              "points": POINTS, "lr": TRAIN_LR}

    def launches_now():
        return {"K1": group.launches, "K5": gather.launches,
                "K6": sa.launches}

    def run(route: str, steps: int, check_fall: bool = True, **kwargs):
        """One `train(...)` call -> (state, model, record)."""
        model = _train_model()
        before = _fixed_draw_loss(model, diffusion, on_card)
        rec = {"loss": [], "events": [], "walls": [], "launches": [],
               "grads": None}

        def on_step(i, state, metrics):
            rec["loss"].append(metrics["loss"])
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            rec["events"].append(event)
            rec["walls"].append(time.perf_counter())
            rec["launches"].append(launches_now())
            if i == 1:
                rec["grads"] = {n: p.grad.detach().clone()
                                for n, p in state.params.items()
                                if p.grad is not None}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(group, nn, sa)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as results, _fused_route(
                route == "INTERDIFF_FUSED_SA=1"):
            state, summary = train(
                model, diffusion, lambda: [batch] * steps,
                results_dir=results, epochs=1, lr=TRAIN_LR,
                val_diffusion=val_diffusion,
                generator=torch.Generator(device=DEV).manual_seed(SEED),
                on_step=on_step, **kwargs)
            saved = sorted(os.listdir(results))
        torch.cuda.synchronize()
        rec["total"] = launches_now()
        rec["wall_s"] = time.perf_counter() - t0
        events, walls = [start] + rec["events"], [t0] + rec["walls"]
        step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        wall_ms = [(b - a) * 1e3 for a, b in zip(walls, walls[1:])]
        per_step = [{k: b[k] - a[k] for k in a} for a, b in zip(
            [{"K1": 0, "K5": 0, "K6": 0}] + rec["launches"],
            rec["launches"])]
        losses = torch.stack(rec["loss"]).tolist()
        after = _fixed_draw_loss(model, diffusion, on_card)
        ms = statistics.median(step_ms[1:])
        rec["line"] = {
            **common, "route": route, "steps": summary["steps"],
            "loss_first_step": losses[0], "loss_last_step": losses[-1],
            "fixed_draw_loss_before": before, "fixed_draw_loss_after": after,
            "ms_per_step_cuda_events_median": ms,
            "ms_per_step_wall_median": statistics.median(wall_ms[1:]),
            "ms_first_step": step_ms[0],
            "steps_per_s": 1e3 / ms, "seq_per_s": CLIPS * 1e3 / ms,
            "launches_per_step": per_step[0], "launches_total": rec["total"],
            "val_loss": summary["val_loss"], "saved": saved,
            "wall_s_with_validation": rec["wall_s"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        if summary["steps"] != steps or len(set(map(
                lambda d: tuple(sorted(d.items())), per_step))) != 1:
            raise AssertionError(f"{route}: launches per step {per_step}")
        if not (np.isfinite(losses).all() and np.isfinite(after)
                and (after < before or not check_fall)):
            raise AssertionError(f"{route}: losses {losses}, fixed-draw "
                                 f"loss {before} -> {after}")
        return state, model, rec

    # -- default route, EMA on, one validation
    state, model, default = run("default", TRAIN_STEPS, ema_decay=0.999,
                                validate_every_epoch=True)
    line = default["line"]
    if line["launches_per_step"] != {"K1": 2, "K5": 0, "K6": 0} or \
            line["launches_total"] != {"K1": 2 * TRAIN_STEPS + 2, "K5": 0,
                                       "K6": 0}:
        raise AssertionError(f"default route launches: {line}")
    if not (len(line["val_loss"]) == 1 and np.isfinite(line["val_loss"][0])
            and line["saved"] == ["ckpt", "ckpt_ema", "metrics.jsonl"]):
        raise AssertionError(f"default route validation: {line}")
    name = "bodyFinalLinear.weight"
    line["ema_differs_from_weights"] = float(
        (state.ema_params[name] - state.params[name].detach()).abs().max())
    if not line["ema_differs_from_weights"] > 0:
        raise AssertionError("the EMA shadow equals the weights")
    line["split"] = _step_split(model, diffusion, on_card)
    emit(line)

    # -- the fused route (K6 in place of K1 + SharedMLP + amax)
    _, model, fused = run("INTERDIFF_FUSED_SA=1", TRAIN_STEPS,
                          validate_every_epoch=True)
    line = fused["line"]
    if line["launches_per_step"] != {"K1": 0, "K5": 0, "K6": 2} or \
            line["launches_total"] != {"K1": 0, "K5": 0,
                                       "K6": 2 * TRAIN_STEPS + 2}:
        raise AssertionError(f"fused route launches: {line}")
    with _fused_route(True):
        line["split"] = _step_split(model, diffusion, on_card)
    errs = {}
    for n, g in default["grads"].items():
        tol = next(t for prefix, t in ROUTE_GRAD_TOL.items()
                   if n.startswith(prefix))
        err = float((g - fused["grads"][n]).abs().max() / g.abs().max())
        errs[tol] = max(errs.get(tol, (0.0, "")), (err, n))
        if not err <= tol:
            raise AssertionError(f"gradient of {n} differs between the "
                                 f"routes by {err} > {tol}")
    line["first_step_grads_vs_default_route"] = {
        "tensors": len(default["grads"]),
        "max_rel_err_stage1": errs[5e-3], "tolerance_stage1": 5e-3,
        "max_rel_err_rest": errs[1e-4], "tolerance_rest": 1e-4,
        "tolerance_reason": "each tensor relative to its largest entry; "
        "stage 1's weight gradients are sums of about a million float32 "
        "products, taken by GEMMs on the default route and in K6's "
        "backward over the saved grouped tensor on this one"}
    emit(line)

    # -- bn_train_mode: batch statistics, running statistics by momentum
    # (no check of the fixed-draw loss, which is taken in eval mode: after
    # five steps the running statistics still lie between their seeded
    # start and the batch statistics the steps normalised with)
    state, model, bn = run("default, bn_train_mode", 5, check_fall=False,
                           bn_train_mode=True, val_every=10 ** 9)
    line = bn["line"]
    fresh = seeded_state(model, SEED + 1)
    optimised = {id(p) for g in state.optimizer.param_groups
                 for p in g["params"]}
    moved = {n: float((v.detach().cpu() - fresh[n]).abs().max())
             for n, v in state.model_state.items()}
    line["running_statistics"] = {
        "tensors": len(moved), "least_move": min(moved.values()),
        "in_optimiser": sum(id(v) in optimised
                            for v in state.model_state.values())}
    if line["launches_per_step"] != {"K1": 2, "K5": 0, "K6": 0} or \
            len(moved) != 24 or not min(moved.values()) > 1e-4 or \
            line["running_statistics"]["in_optimiser"] or line["val_loss"]:
        raise AssertionError(f"bn_train_mode: {line}")
    emit(line)

    # -- the gradient with respect to the object cloud: K1's backward
    model = _train_model()
    pts = on_card["obj_points"].clone().requires_grad_(True)
    _reset_launches(group, nn, sa)
    gt, _ = trainer.smpl_cond_inputs(on_card)
    memory = model.encode(gt, pts)
    memory.square().mean().backward()
    torch.cuda.synchronize()
    cloud = launches_now()
    if cloud != {"K1": 2, "K5": 2, "K6": 0} or not bool(
            torch.isfinite(pts.grad).all()) or not float(
                pts.grad[..., :3].abs().max()) > 0:
        raise AssertionError(f"cloud gradient: launches {cloud}")
    emit({**common, "path": "encode forward and backward with respect to "
          "the object cloud", "launches": cloud,
          "largest_cloud_gradient": float(pts.grad.abs().max())})
    return {"K1": default["line"]["launches_total"]["K1"],
            "K5": cloud["K5"],
            "K6": fused["line"]["launches_total"]["K6"]}


def _device_events(prof):
    """(the profile's device events, their summed time in ms, the eight
    kernel names with the most time as (name, microseconds))."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = {}
    for e in events:
        by_kernel[e.name[:60]] = by_kernel.get(e.name[:60], 0.0) + e.device_time
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return events, sum(e.device_time for e in events) / 1e3, top


@torch.no_grad()
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
    events, busy_ms, top = _device_events(prof)
    emit({"phase": "profile", "gpu": gpu, "rows": CLIPS * FOLD, "steps": 10,
          "fired_at": [e["t"] for e in trace],
          "hook_ms": [e["start"].elapsed_time(e["end"]) for e in trace],
          "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if events else "not measured",
          "device_idle_share": (1 - busy_ms / wall_ms) if events
          else "not measured",
          "kernel_launches": len(events),
          "top_kernels_ms": {name: us / 1e3 for name, us in top}})


def phase_profile_train(gpu: str) -> None:
    """Device busy share of five full-width train steps (default route)
    under torch.profiler, after two warm-up steps."""
    from torch.profiler import ProfilerActivity, profile

    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.train import trainer

    rng = np.random.default_rng(SEED + 20)
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in _main_path_batch(
        rng, CLIPS, FRAMES, POINTS).items() if k in TRAIN_KEYS}
    model = _train_model()
    step = trainer.make_smpl_train_step(model, DiffusionConfig().build())
    state = trainer.TrainState.create(dict(model.named_parameters()),
                                      trainer.adamw(TRAIN_LR))
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    for _ in range(2):
        step(state, batch, gen)
    torch.cuda.synchronize()
    steps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events, busy_ms, top = _device_events(prof)
    emit({"phase": "profile", "gpu": gpu, "path": "train step",
          "clips": CLIPS, "steps": steps, "wall_ms": wall_ms,
          "wall_ms_per_step_under_profiler": wall_ms / steps,
          "device_busy_ms": busy_ms if events else "not measured",
          "device_idle_share": (1 - busy_ms / wall_ms) if events
          else "not measured",
          "kernel_launches_per_step": len(events) / steps,
          "top_kernels_ms_per_step": {name: us / 1e3 / steps
                                      for name, us in top}})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: sees {torch.cuda.device_count()} devices, runs "
              "on one: set CUDA_VISIBLE_DEVICES to one card", file=sys.stderr)
        return 2
    from interdiff_torch.ops import gather, group, nn, pointcloud, sa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_name_and_power()
    phase_build(group, nn, sa, gather, gpu)
    models = full_width_models()
    timed = {"K1": phase_kernels(group, pointcloud, gpu),
             **phase_kernels_nn(nn, models[2], gpu),
             "K5": phase_kernels_gather(gather, group, pointcloud, gpu),
             "K6": phase_kernels_sa(sa, group, pointcloud, gpu)}
    phase_grads(gather, group, sa, nn, pointcloud, models[2], gpu)
    phase_slice_cpu_vs_gpu(gpu)
    phase_slice_eval_cpu_vs_gpu(gpu)
    phase_slice_train_cpu_vs_gpu(group, sa, gpu)
    phase_sampler(group, nn, sa, models, gpu)
    eval_launches = phase_eval(group, nn, sa, models, gpu)
    train_launches = phase_train(group, nn, sa, gather, gpu)
    phase_profile(models, gpu)
    phase_profile_train(gpu)
    # every kernel must have run on a main path: the eval entry point's
    # (K1-K4; K6 on its opt-in route) or the training entry point's (K1; K6
    # on its opt-in route; K5 in the backward with respect to the cloud)
    by_path = {"eval": eval_launches,
               "train": {"K2": 0, "K3": 0, "K4": 0, **train_launches}}
    launches = {k: by_path["eval"][k] + by_path["train"][k]
                for k in by_path["eval"]}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never ran on a main path: {by_path}")

    print(gpu)
    emit({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"interdiff_torch/csrc/{source}",
        "replaces": f"interdiff_tpu/ops/{replaces}",
        "launches": launches[key],
        "launches_by_path": {path: n[key] for path, n in by_path.items()},
        **{k: timed[key][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        **{k: timed[key][k] for k in ("frames", "plain_frames", "unfused_ms",
                                      "with_grouped_ms")
           if k in timed[key]}}
        for key, name, source, replaces in (
            ("K1", "K1 ball_group", "ball_group.cu", "pallas_group.py:143"),
            ("K2", "K2 signed_nearest_pruned", "nn.cu", "pallas_nn.py:352"),
            ("K3", "K3 signed_nearest", "nn.cu", "pallas_nn.py:145"),
            ("K4", "K4 nearest_neighbor", "nn.cu", "pallas_nn.py:107"),
            ("K5", "K5 gather_rows", "gather.cu", "pallas_gather.py:72"),
            ("K6", "K6 fused_sa_scale", "sa.cu", "pallas_sa.py:194"))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
