"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines (any failure exits non-zero):

1. build: compiles `interdiff_torch/csrc/ball_group.cu` (kernel K1),
   `interdiff_torch/csrc/nn.cu` (K2, K3, K4), `interdiff_torch/csrc/sa.cu`
   (K6) and `interdiff_torch/csrc/gather.cu` (K5) with nvcc, all four at
   once; ptxas's registers, spills and shared memory of every kernel.
2. kernels: each kernel against its plain PyTorch version on the card,
   bitwise, at the main-path shapes; kernel and plain times by CUDA events
   (median of 30 runs after warm-up) beside the bound of this run's data.
   K1: B=32 clouds, N=2048 points, M=1024 centers, C=4, both radius scales;
   `k1_edge_cloud` with C=4 and C=3 (zero-hit, short and full rows, hits on
   both sides of a word and of a round boundary of its walk, the S-th hit at
   candidate N-1, a block that fills in the first round beside one that
   never fills, N=300 and M=120 not multiples of a round and of a block);
   a cloud of N=12500 (shared memory past 48 KB); ptxas's registers and the
   waves of its launch; one call captured in a CUDA graph.  K2, K3: 1600
   frames of N=2048 object points against the M=6890 vertices and normals
   of the posed stand-in body; the plain versions on the first
   16 frames (a full [1600, 2048, 6890] score tensor is 90 GB); K2 against
   K3 on all frames (bit-equal inside delta, forced beyond).  The object
   clouds are placed so that the run covers penetrating queries, queries
   inside delta outside the body, queries beyond delta, frames with some
   segments skipped and frames with every segment skipped.  K2's prologue
   (flags, count, compacted ids) against `segment_flags` and
   `segment_list_plain` on that data; the registers, spills and waves of
   the sweep of K2 and of K3 (one body, K3 its full variant); one call of
   each captured in a CUDA graph (one launch), its replay equal to the
   eager call; the device time of each of K2's three kernels and of
   `segment_flags` (torch.profiler).  K4: 2240 frames of 67 markers
   against 2048 points, whole; its registers and the waves of its launch
   (a block a frame); one call captured in a CUDA graph.  All three also on
   a small case with duplicated surface rows (exact ties), a one-point
   cloud and an all-far frame; K2 and K3 also on ties across a group and a
   tile boundary (`nn_tie_frames`) and K2 on a frame whose flagged segments
   have gaps; K4 also on `k4_tie_frames` (ties across a thread's 16
   points, a warp's 512, a segment, a pass of 2048 and the whole frame, at
   N from 1 to 97 and M from 1 to 4100, and a frame whose queries all sit
   on one point).  In the phase's line, beside each bound, the issue floor
   worked out from `F32_INSTR_PER_S` (derived, not measured; so it stays
   out of the kernel table below).
   K5: K1's data with the indices the ball query picks there (K = 1024 *
   16 and 1024 * 32, int64 and int32), every C in 1..8 on an aligned base
   and on one offset by a float, and
   K = 1, repeated indices, the last row, -0.0 and out-of-range indices (a
   zero row); one launch captured in a CUDA graph; its time and
   `torch.gather`'s for one launch between two events (`ms` and
   `library_ms`, as for every kernel), 50 back to back and 50 replayed from
   a graph (`device_ms` and `library_device_ms`: the device's time a
   launch), and the time of its smallest launch.  K6: K1's
   shape and inputs, both scales with the encoder's chains 4->16->16->32
   (S=16) and 4->32->32->64 (S=32) on seeded weights folded by
   `folded_affine`, and K1's edge rows; beside its time the plain version's
   (5 runs) and, in place of a library call, the unfused route's (K1 +
   `SharedMLP` + `amax`); then the `with_grouped` variant: features bitwise
   equal to the variant without, grouped tensor bitwise equal to K1's output;
   every output compared as bits (+0.0 against -0.0); each scale's
   registers, waves, issue floor and one call in a CUDA graph; K1's edge
   rows at C=4 also with the encoder's chains (the kernel's lane-per-slot
   path).
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
   times each), with the hook's time and the shares of flagged segments
   (from K2's prologue),
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
9. skeleton_cpu_vs_gpu: the skeleton track's small runs (2 + 2 layers,
   width 32, 2 clips of 20 frames, seeded weights) on the card and on the
   CPU with the same noise: the sampler on "10" respacing without
   correction (within 1e-5) and with it (the gate at t = 9, 6, 3, 0;
   within CORRECTED_TOL), `evaluate` with correction and one rollout
   (metrics within 1e-4), three train steps (loss within 1e-5, parameters
   within 2 * steps * lr); no kernel launched.
10. skeleton: the skeleton entry points at full width: `MDMSkeleton`
   defaults, 1000 DDPM steps, 32 clips of 20 frames of
   `synthetic_skeleton_batches`: `evaluate` with correction (11 firings),
   without, and with `--rollouts 1` (sequences/s, ms per DDPM step, hook ms
   per firing, the parts' seconds; past frames equal to gt), `train(...)`
   for 20 steps with one validation at "25" respacing (ms per step, loss
   before and after, peak memory), and a corrected 10-step call under
   torch.profiler (launches per step, device busy share); 0 launches of
   every kernel on both paths.
11. correction_cpu_vs_gpu: three steps of each correction trainer (SMPL
   through the initialize phase and the main phase, with the same marker
   draws; skeleton) and a 5-iteration refine of two clips on a 256-vertex
   stand-in body, started 0.01 off its anchors, card against CPU: losses
   within 1e-5, parameters and BatchNorm statistics within 2 * steps * lr,
   refined poses, best losses and every trace row within REFINE_TOL
   relative (reason in the line).
12. correction_train: `train(...)` of `cli/train_correction_smpl.py` at the
   CLI's defaults (16 clips of 10 + 25 frames, 67 markers) on batches of
   the V=6890 body with 2048-point clouds (`correction_batch`), 20 steps
   (10 in the initialize phase, 10 in the main one): K3 and K4 once a step
   each, forward and backward; K4 at N=6890 queries (a ragged last chunk)
   and K3 at this shape bitwise against their plain versions, with times,
   bounds and, for K4, `torch.cdist`'s; the loss's gradient through both
   against autograd through the plain versions on 2 clips.  Then
   `cli/train_correction_skeleton.py`'s `train(...)`, 20 steps of 32 clips
   of 10 + 10 frames, no kernel.  ms per step, losses, peak memory.
13. refine: `cli/optimization.py`'s generate-then-refine path at full
   width (a rest-pose `MDMSmpl` of 10 + 10 frames, 8 clips, 2048 points,
   "100" respacing, 200 iterations, V=6890): seconds of each part, ms per
   iteration, launches (K1 2, K2 2, K3 and K4 one an iteration), the
   penetration before and after, every trace term finite; K3 and K4 at
   the refiner's shapes, K4 beside `torch.cdist`'s time; the refiner's gradient through K3 with respect to
   the queries, the surface and its normals against autograd through the
   plain versions.
14. behave_cpu_vs_gpu: a small corpus of `write_behave_corpus` (one train
   and one test sequence of 120 frames, 512 points) with the 128-vertex
   stand-in body read back from its SMPL-H pkl on each device: the
   load-time vertices within LOAD_TOL, the normals within NORMALS_TOL (and
   within LOAD_TOL of the CPU's normals of the card's vertices), each
   device with its own normals cache; the clips' start frames and the arrays that do not go
   through FK identical, the translations within LOAD_TOL; `evaluate` of 2
   light test clips at "5" respacing with correction, the same batch and
   noise on both: every metric within 1e-4.
15. behave: the dataset routes at full width on a written corpus (2 train
   and 2 test sequences of 1,408 frames, 2048 points; the V=6890 stand-in
   body as SMPLH_{male,female}.pkl, read back through the loader): the load
   (seconds per sequence of FK + normals and of the files), seconds per
   clip of canonicalization with light and full fields; `evaluate` on 32
   test clips, 4 diverse samples, correction, "100" respacing (launches K1
   2, K2 4, K4 4, K3 2); 20 steps of the diffusion trainer on the train
   split with a validation on the first test batch (K1 42); 20 steps of
   the correction trainer on 16 clips with every field, the host's data
   seconds apart (K3 = K4 = 20); the refiner's dataset route on 8 test
   clips, 200 iterations (K2 2, K3 = K4 = 200).
16. long_eval: `cli/eval_smpl_long.py` at its CLI's defaults (8 test
   clips, 4 rollouts, 1000 DDPM steps, ``--mode correction``) on that
   corpus through ``--model_path``: `setup` from the parsed flags, the
   serving weights of `full_width_models`, `evaluate_long` on one batch:
   seconds per chunk, sequences per second, launches per batch K1 10 (5
   encodes), K2 55, K4 55, K3 0, the rollout [8, 135, 144] finite, the
   drift of each window; then that batch at "100" respacing from one seed
   through the kernels and through their plain versions
   (`_plain_kernels`): the trajectories within PLAIN_TRAJECTORY_TOL.

Then the card's name and power limit (nvidia-smi), the kernel table as one
JSON line (launches: the eval phase's plus the train phase's, each also on
its own, beside the skeleton paths' zeros, the correction trainers',
the refiner's, the dataset routes' and the long-term eval's; K6's of its
opt-in routes, K5's of the backward with
respect to the cloud; K3 and K4 also at this slice's shapes), and the
device line.  Weights and data come from numpy seeds;
no file outside this repository and no network is needed.  The run uses one
card: it sees only device 0 unless CUDA_VISIBLE_DEVICES says otherwise, and
stops if that shows more than one.  A few minutes on an H100.  Depth cut to
fit: the full-sweep sampler path runs 100 respaced steps, the fused-route
sampler call 100, the validations inside the train phases 25, the
dataset-mode eval 100, the long-term eval one batch of its three.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import re
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
# separately rounded f32 instructions a second: the 67e12 above counts an
# FMA as two operations, but a __fmul_rn or __fadd_rn (the kernels' bitwise
# contract allows no contraction) is one instruction of one lane: 132 SMs x
# 128 f32 lanes x about 1.98 GHz (boost clock) = 33.45e12.  A kernel's issue
# floor is its operations over this rate (and never under its byte time)
F32_INSTR_PER_S = 132 * 128 * 1.98e9
# K2-K4, per pair: 3 mul + 2 add (a.b), 1 mul + 1 sub (score), 1 compare
NN_OPS_PER_PAIR = 8
# ... as the kernels issue them: the score's mul and sub are one fma
# (exact: 2*dot is), so 3 mul + 2 add + 1 fma + 1 min
NN_INSTR_PER_PAIR = 7
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


def _build_report(source: str) -> list:
    """ptxas's registers, spills and shared memory of each kernel of
    `interdiff_torch/csrc/<source>.cu` (the library's build log)."""
    from interdiff_torch.ops import _build

    return _build.ptxas_report(source)


def phase_build(group, nn, sa, gather, gpu: str) -> None:
    """The four libraries, one nvcc each, started together; ptxas's report
    of each kernel's registers and spills."""
    def timed(kernels, module):
        t0 = time.perf_counter()
        path = module.build()
        return {"phase": "build", "gpu": gpu, "kernels": kernels,
                "library": path, "seconds": time.perf_counter() - t0,
                "ptxas": _build_report(module.SOURCE)}

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(timed, "K1", group),
                pool.submit(timed, "K2 K3 K4", nn),
                pool.submit(timed, "K6", sa),
                pool.submit(timed, "K5", gather)]
        for job in jobs:
            emit(job.result())


# K1's block (`csrc/ball_group.cu`): 32 queries and 8 warps, each warp
# reading a hit word of 32 candidates a round
K1_BLOCK_QUERIES, K1_WARPS, K1_WORD = 32, 8, 32
K1_ROUND = K1_WARPS * K1_WORD  # candidates a round


def k1_edge_cloud(seed: int = SEED + 3):
    """(xyz [2, 300, 3], new_xyz [2, 120, 3]) float32 numpy: the rows that
    the main-path data rarely has, for K1 and K6.  A sparse background
    (short rows) and three tight clusters far from it: A, 40 points at
    candidates 10-49 (across the word boundary 31|32), under queries 0-31,
    so that block 0 fills in the first round while block 1's background
    queries never fill; R, 20 points at 248-267 (across the round boundary
    255|256); E, 16 points whose last is candidate N-1 = 299, and 16 more on
    a shell 0.06-0.08 m out, so that the S-th hit is candidate N-1 at
    r = 0.05, S = 16 and at r = 0.1, S = 32.  Queries 64 and 65 sit on R
    and E, the last 8 far from everything (zero-hit rows).  N is not a
    multiple of a round or of a word, M not one of a block."""
    rng = np.random.default_rng(seed)
    B, N, M = 2, 300, 120
    xyz = rng.uniform(-0.4, 0.4, (B, N, 3))
    a, r, e = np.eye(3) * 1.5

    def tight(center, idx):
        xyz[:, idx] = center + rng.uniform(-0.004, 0.004, (B, len(idx), 3))

    tight(a, np.arange(10, 50))
    tight(r, np.arange(248, 268))
    tight(e, np.r_[240:248, 284:291, N - 1])
    shell = rng.standard_normal((B, 16, 3))
    shell /= np.linalg.norm(shell, axis=-1, keepdims=True)
    xyz[:, 200:216] = e + shell * rng.uniform(0.06, 0.08, (B, 16, 1))
    new_xyz = np.empty((B, M, 3))
    new_xyz[:, :32] = a + rng.uniform(-0.002, 0.002, (B, 32, 3))
    new_xyz[:, 32:64] = xyz[:, 60:92]
    new_xyz[:, 64], new_xyz[:, 65] = r, e
    new_xyz[:, 66:112] = xyz[:, 100:146]
    new_xyz[:, 112:] = 3.0 + rng.uniform(0.0, 1.0, (B, 8, 3))
    return xyz.astype(np.float32), new_xyz.astype(np.float32)


def k1_row_kinds(d2t, r2: float, S: int) -> dict:
    """How many rows of d2t [B, N, M] (any device) are of each kind at one
    radius scale: zero-hit, short and full rows; rows whose slot-taking hits
    lie on both sides of a word boundary or of a round boundary of K1's
    walk; rows whose S-th hit is candidate N-1; pairs of neighbouring
    blocks of which one fills in the first round and the other never; and
    1 if N is not a multiple of a round."""
    B, N, M = d2t.shape
    hit = d2t < r2
    rank = torch.cumsum(hit, dim=1)
    total = rank[:, -1]
    taken = hit & (rank <= S)  # the hits that fill slots
    fill = torch.where(total >= S, (rank < S).sum(dim=1),
                       torch.full_like(total, N))  # the S-th hit, or N

    def straddling(period: int) -> int:
        k = torch.arange(period, N, period, device=d2t.device)
        return int((taken[:, k - 1] & taken[:, k]).any(dim=1).sum())

    pad = -M % K1_BLOCK_QUERIES  # queries past M never hold a block back
    block_fill = torch.nn.functional.pad(fill, (0, pad), value=-1).reshape(
        B, -1, K1_BLOCK_QUERIES).amax(dim=-1)
    first, never = block_fill < K1_ROUND, block_fill == N
    return {"zero_hit": int((total == 0).sum()),
            "short": int(((total > 0) & (total < S)).sum()),
            "full": int((total >= S).sum()),
            "word_straddle": straddling(K1_WORD),
            "round_straddle": straddling(K1_ROUND),
            "sth_hit_at_last_candidate": int((fill == N - 1).sum()),
            "first_round_block_beside_never_full": int(
                ((first[:, :-1] & never[:, 1:])
                 | (never[:, :-1] & first[:, 1:])).sum()),
            "ragged_last_round": int(N % K1_ROUND != 0)}


def _edge_rows(group, pointcloud, name: str, kernel, plain,
               channels=(4, 3)) -> dict:
    """``kernel`` against ``plain`` (both called as f(d2t, data, new_xyz,
    radius, S), float32 out) as bits, so that +0.0 and -0.0 differ, on
    `k1_edge_cloud` with each C of ``channels`` (4: xyz and a feature; 3: no
    features), both radius scales.  Returns the row kinds the comparison
    covered, and raises if one is missing."""
    xyz, new_xyz = (torch.from_numpy(x).to(DEV) for x in k1_edge_cloud())
    d2t = group.pairwise_sqdist_t(xyz, new_xyz).contiguous()
    feats = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    by_c = {4: torch.cat([xyz, feats], -1).contiguous(), 3: xyz}
    rows = {}
    for data in (by_c[c] for c in channels):
        for radius, S in SCALES:
            got = kernel(d2t, data, new_xyz, radius, S)
            want = plain(d2t, data, new_xyz, radius, S)
            torch.cuda.synchronize()
            if got.shape != want.shape or not torch.equal(
                    got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{name} differs from its plain "
                                     f"version on edge rows, "
                                     f"C={data.shape[-1]}, r={radius}")
            kinds = k1_row_kinds(d2t, pointcloud.radius_sq(radius), S)
            for kind, count in kinds.items():
                rows[kind] = rows.get(kind, 0) + count
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
    # ptxas's registers and the waves of a launch (the S=32 scale's shared
    # memory: hit words of every round, padded to 33, and a slot list a warp)
    words = -(-N // K1_ROUND) * K1_WARPS * (K1_BLOCK_QUERIES + 1)
    total["ptxas"] = _occupancy(
        next(e for e in _build_report(group.SOURCE)
             if "ball_group_kernel" in e["kernel"]), 32 * K1_WARPS,
        B * -(-M // K1_BLOCK_QUERIES),
        4 * (words + K1_WARPS * min(SCALES[1][1], N)))
    # a cloud of 12,500 points: 52 KB of hit words, past the 48 KB a block
    # gets without asking
    rng = np.random.default_rng(SEED + 16)
    big = torch.from_numpy(rng.uniform(-0.4, 0.4, (1, 12500, 4)).astype(
        np.float32)).to(DEV)
    centers = big[:, 7:47, :3].contiguous()
    big_d2t = group.pairwise_sqdist_t(big[..., :3], centers).contiguous()
    for radius, S in SCALES:
        if not torch.equal(
                group.group_cuda(big_d2t, big, centers, radius, S),
                group.group_plain(big_d2t, big, centers, radius, S)):
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"N=12500, r={radius}")
    # one call (S=32) captured in a CUDA graph: one launch, replay equals
    # eager
    def call():
        return group.group_cuda(d2t, data, new_xyz, *SCALES[1])

    capture, graph = _graph_capture("K1", call, lambda: group.launches,
                                    call())
    capture["replay_ms"] = cuda_ms(graph.replay)
    del graph
    emit({"phase": "kernels", "gpu": gpu, "shape": [B, N, M, 4],
          "bitwise_equal": True, "scales": scales,
          "edge_rows_bitwise_equal": _edge_rows(
              group, pointcloud, "K1", group.group_cuda, group.group_plain),
          "ptxas": total["ptxas"], "graph_capture_s32": capture,
          "n12500_bitwise_equal": True})
    total["library_ms"] = None
    total["bound_by"] = ("bytes" if total["bytes"] / HBM_BYTES_PER_S
                         >= total["ops"] / F32_OPS_PER_S else "operations")
    return total


def _captured(fn, calls: int = 1):
    """(graph, outputs): ``calls`` calls of ``fn`` captured in one CUDA graph
    after a warm-up on a side stream, and the list of their outputs (written
    again by every replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(calls)]
    return graph, outs


def _replay_ms(fn, calls: int = 50) -> float:
    """The device's ms a call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed."""
    graph, _ = _captured(fn, calls)
    return cuda_ms(graph.replay, runs=10) / calls


def _launch_times(fn, calls: int = 50) -> dict:
    """ms a launch of ``fn``: one between two events (host and device), 50
    back to back between one pair (the larger of the host's and the
    device's time a launch), and 50 captured in a CUDA graph and replayed
    (the device's time a launch)."""
    return {"one_launch": cuda_ms(fn),
            "back_to_back": cuda_ms(lambda: [fn() for _ in range(calls)],
                                    runs=5, warmup=1) / calls,
            "graph_replay": _replay_ms(fn, calls)}


def _graph_capture(name: str, fn, launched, want) -> tuple:
    """One call of ``fn`` captured in a CUDA graph: ``launched()`` (the
    wrapper's count) must rise by one in the capture, and the replay, into
    outputs zeroed first, must equal ``want`` bit for bit.  Returns the
    record and the graph."""
    before = launched()
    graph, (replayed,) = _captured(fn)
    captured = launched() - before - 1  # less the warm-up call
    outs = replayed if isinstance(replayed, tuple) else (replayed,)
    wants = want if isinstance(want, tuple) else (want,)
    for t in outs:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    if captured != 1 or not all(map(torch.equal, outs, wants)):
        raise AssertionError(f"{name} in a CUDA graph: {captured} launches "
                             f"captured, or its replay differs")
    return {"launches_captured": captured, "replay_equals_eager": True}, graph


def _occupancy(ptxas: dict, threads: int, blocks: int,
               dynamic_smem: int = 0) -> dict:
    """ptxas's registers and spills of a kernel with the blocks an SM they
    leave room for (65,536 registers an SM, given out per warp in units of
    256; 2048 threads; 228 KB of shared memory, 1 KB of it reserved a
    block) and the waves of a launch of ``blocks`` blocks."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_warp = -(-ptxas["registers"] * 32 // 256) * 256
    smem = ptxas["smem_bytes"] + dynamic_smem + 1024
    per_sm = min(65536 // (per_warp * (threads // 32)), 2048 // threads, 32,
                 233472 // smem)
    return {**{k: ptxas[k] for k in ("kernel", "registers", "spill_stores",
                                     "spill_loads", "smem_bytes")},
            "threads": threads, "dynamic_smem_bytes": dynamic_smem,
            "blocks_per_sm": per_sm, "blocks": blocks,
            "waves": blocks / (per_sm * sms)}


def phase_kernels_gather(gather, group, pointcloud, gpu: str) -> dict:
    """K5 at K1's shape (the indices the ball query picks there, both
    scales) and on edge rows, bitwise against `gather_rows_plain`: every C
    in 1..8 on a 16-byte-aligned base and on one offset by a float; one
    launch captured in a CUDA graph against the eager call.  Its times, one
    launch, 50 back to back and 50 replayed from a graph, beside the bound,
    the plain version and the same three of the one PyTorch call
    `torch.gather`."""
    data, new_xyz, d2t = _stage1_inputs(group, pointcloud)
    B, N, C = data.shape
    scales, total = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                         "library_ms": 0.0, "max_abs_err": 0.0}
    for k in ("device_ms", "ms_back_to_back", "library_device_ms",
              "library_ms_back_to_back"):
        total[k] = 0.0
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
        kernel = _launch_times(lambda: gather.gather_rows_cuda(data, idx))
        library = _launch_times(lambda: torch.gather(data, 1, pick))
        scales.append({
            "nsample": S, "K": idx.shape[1],
            "ms": kernel["one_launch"],
            "ms_back_to_back": kernel["back_to_back"],
            # the device's time a launch: 50 launches replayed from a graph
            "device_ms": kernel["graph_replay"],
            "device_ms_int32_idx": _replay_ms(
                lambda: gather.gather_rows_cuda(data, idx32)),
            "plain_ms": cuda_ms(lambda: gather.gather_rows_plain(data, idx)),
            "library_ms": library["one_launch"],
            "library_ms_back_to_back": library["back_to_back"],
            "library_device_ms": library["graph_replay"],
            "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bytes": n_bytes,
            "max_abs_err": float((got - want).abs().max())})
        for k in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                  "ms_back_to_back", "library_device_ms",
                  "library_ms_back_to_back"):
            total[k] += scales[-1][k]

    # every C on an aligned base and on one a float off (the float4 copy at
    # C = 4 only where data and output are 16-byte aligned), int64 and int32
    rng = np.random.default_rng(SEED + 14)
    widths = {}
    for c in range(1, gather.MAX_C + 1):
        buf = torch.from_numpy(rng.standard_normal(B * N * c + 1).astype(
            np.float32)).to(DEV)
        buf[1::7] = -0.0
        ix = torch.from_numpy(rng.integers(0, N, (B, 1024 * 16))).to(DEV)
        for base, d in (("aligned", buf[:-1].view(B, N, c)),
                        ("offset_one_float", buf[1:].view(B, N, c))):
            want = gather.gather_rows_plain(d, ix)
            for ixt in (ix, ix.to(torch.int32)):
                got = gather.gather_rows_cuda(d, ixt)
                if not torch.equal(got, want) or not torch.equal(
                        torch.signbit(got), torch.signbit(want)):
                    raise AssertionError(f"K5 differs at C={c} on the "
                                         f"{base} base, {ixt.dtype}")
            widths[f"c{c}_{base}"] = d.data_ptr() % 16
    torch.cuda.synchronize()

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

    # one call captured in a graph: one launch, the replay equals the eager
    idx = pointcloud.ball_query(data[..., :3], new_xyz, *SCALES[1],
                                d2=d2t.transpose(1, 2)).reshape(B, -1)
    capture, graph = _graph_capture(
        "K5", lambda: gather.gather_rows_cuda(data, idx),
        lambda: gather.launches, gather.gather_rows_cuda(data, idx))
    del graph
    one = torch.zeros((1, 1), dtype=torch.int64, device=DEV)
    emit({"phase": "kernels", "gpu": gpu, "kernels": "K5",
          "shape": [B, N, C], "bitwise_equal": True, "scales": scales,
          "launch_floor_ms": cuda_ms(
              lambda: gather.gather_rows_cuda(data[:1], one)),
          "library": "torch.gather(data, 1, idx[..., None].expand(-1, -1, C))",
          "every_c_bitwise_equal": widths,
          "edge_rows_bitwise_equal": edge,
          "out_of_range_index_gives_zero_row": True,
          "graph_capture": capture})
    total["bound_by"] = "bytes"
    return total


def _seeded_shared_mlp(c_in: int, channels, seed: int):
    from interdiff_torch.models.pointnet import SharedMLP

    mlp = SharedMLP(c_in, channels)
    mlp.load_state_dict(seeded_state(mlp, seed), strict=True)
    return mlp.to(DEV).eval()


def _k6_smem(N: int, S: int, n_params: int) -> int:
    """Dynamic shared memory of a K6 block (`csrc/sa.cu`): the folded
    weights, K1's hit words of every round, a slot list and a hit count a
    query."""
    words = -(-N // K1_ROUND) * K1_WARPS * (K1_BLOCK_QUERIES + 1)
    return 4 * (n_params + words + K1_BLOCK_QUERIES * (min(S, N) + 1))


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
                         "issue_floor_ms": 0.0, "graph_replay_ms": 0.0,
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
            # the bits, so that +0.0 and -0.0 count as different
            if got.shape != want.shape or not torch.equal(
                    got.view(torch.int32), want.view(torch.int32)):
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
            # one call captured in a CUDA graph: one launch, replay equal
            capture, graph = _graph_capture(
                f"K6 S={S}", lambda: sa.sa_cuda(d2t, data, new_xyz, params,
                                                radius, S),
                lambda: sa.launches, got)
            capture["replay_ms"] = cuda_ms(graph.replay)
            total["graph_replay_ms"] += capture["replay_ms"]
            del graph
            scales.append({
                "radius": radius, "nsample": S, "widths": list(widths),
                "ms": ms, "with_grouped_ms": grouped_ms,
                "with_grouped_equals_k6_and_k1": True,
                "plain_ms": plain_ms, "unfused_ms": unfused_ms,
                "bound_ms": bound_ms,
                "issue_floor_ms": issue_floor_ms(n_ops, n_bytes),
                "graph_capture": capture, "ptxas": _occupancy(
                    next(e for e in _build_report(sa.SOURCE)
                         if f"sa_lane_kernelILi{C}ELi{channels[0]}E"
                         in e["kernel"]), 32 * K1_WARPS,
                    B * -(-M // K1_BLOCK_QUERIES), _k6_smem(N, S, n_params)),
                "bytes": n_bytes, "ops": n_ops,
                "ops_all_slots": 2 * macs * S * M * B,
                "distinct_slots_mean": slots / (B * M),
                "max_abs_err": float((got - want).abs().max()),
                "max_abs_diff_vs_unfused": vs_unfused})
            for k in ("ms", "with_grouped_ms", "plain_ms", "unfused_ms",
                      "bound_ms", "issue_floor_ms", "bytes", "ops"):
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

        # the encoder's chains on the edge rows: C = 4 and each scale's
        # widths, the shapes the lane kernel is built for
        chains = {S: sa.folded_affine(_seeded_shared_mlp(
            C, channels, SEED + 11 + i))
            for i, ((_, S), channels) in enumerate(zip(SCALES, STAGE1_MLPS))}

        def lane_chain(fn):
            return lambda d, x, c, r, S: torch.cat([t.flatten() for t in fn(
                d, x, c, chains[S], r, S, with_grouped=True)])

        lane_edge = _edge_rows(group, pointcloud, "K6 encoder chains",
                               lane_chain(sa.sa_cuda),
                               lane_chain(sa.sa_plain), channels=(C,))
    emit({"phase": "kernels", "gpu": gpu, "kernels": "K6",
          "shape": [B, N, M, C], "bitwise_equal": True, "scales": scales,
          "edge_rows_bitwise_equal": edge,
          "edge_rows_encoder_chains_bitwise_equal": lane_edge})
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
    want = nn.signed_nearest_pruned_plain(a, b, n, 0.25)
    _equal_parts("K2 edge rows", nn.signed_nearest_pruned_cuda(a, b, n, 0.25),
                 want)
    _equal_parts("K4 edge rows", nn.nearest_neighbor_cuda(a, b),
                 nn.nearest_neighbor_plain(a, b))
    torch.cuda.synchronize()
    d2 = nn.delta_squared(0.25)
    rows = {"tied_winners_first": int((k3[2] < M // 2).sum()),
            "one_point_cloud_inside_delta": int((want[0][1] < d2).sum()),
            "all_far_forced": int((want[0][2] == d2).sum())}
    if rows["tied_winners_first"] != B * N or rows["all_far_forced"] != N \
            or rows["one_point_cloud_inside_delta"] != N:
        raise AssertionError(f"edge check missed a row kind: {rows}")
    return rows


# surface rows repeated in `nn_tie_frames`: (first, copy); the first must win
NN_TIES = ((7, 8), (2, 5), (255, 256), (255, 257))


def nn_tie_frames(seg: int = 256, seed: int = SEED + 15):
    """(a [2, 200, 3], b [2, 5 * seg, 3], n) float32 numpy, two frames built
    for the sweeps of K2 and K3 (groups of 8 points, tiles of ``seg``).
    Frame 0: surface rows repeated across a group boundary (7 -> 8), inside
    a group (2 -> 5) and across a tile boundary (255 -> 256, 257), with
    queries on those rows, so each tie's first index must win.
    Frame 1: five segments, the second and fourth moved 5 m away, so K2's
    flagged list has gaps (0, 2, 4)."""
    rng = np.random.default_rng(seed)
    M, N = 5 * seg, 200
    b = rng.standard_normal((2, M, 3)) * 0.3
    for src, dst in NN_TIES:
        b[0, dst] = b[0, src]
    a = np.empty((2, N, 3))
    a[0] = b[0, [7, 2, 255] * (N // 3) + [7] * (N % 3)] + \
        rng.standard_normal((N, 3)) * 1e-3
    b[1, seg:2 * seg] += 5.0
    b[1, 3 * seg:4 * seg] += 5.0
    a[1] = b[1, rng.choice(np.r_[0:seg, 2 * seg:3 * seg, 4 * seg:M], N)] \
        + rng.standard_normal((N, 3)) * 0.01
    return tuple(x.astype(np.float32) for x in (
        a, b, rng.standard_normal((2, M, 3))))


def _k2_k3_ties_and_gaps(nn) -> dict:
    """K2 and K3 against their plain versions on `nn_tie_frames`: the first
    index of every tie wins in both, and K2's prologue compacts the gap
    frame to (0, 2, 4).  (K3 splits the queries of a frame over blocks,
    never its surface, so no merge point needs a tie of its own.)"""
    a, b, n = (torch.from_numpy(x).to(DEV)
               for x in nn_tie_frames(nn.SEGMENT))
    want = nn.signed_nearest_pruned_plain(a, b, n, 0.25)
    got = nn._signed_nearest_pruned_launch(a, b, n, 0.25)
    _equal_parts("K2 ties and gaps", got[:3], want)
    want3 = nn.signed_nearest_plain(a, b, n)
    _equal_parts("K3 ties and gaps", nn.signed_nearest_cuda(a, b, n), want3)
    torch.cuda.synchronize()
    first = {src: int((want3[2][0] == src).sum()) for src in (7, 2, 255)}
    later = set(want3[2][0].tolist()) & {dst for _, dst in NN_TIES}
    count, ids = got[4], got[5][1].tolist()
    if min(first.values()) == 0 or later or ids != [0, 2, 4, -1, -1] \
            or int(count[1]) != 3 or not torch.equal(want[2], want3[2]):
        raise AssertionError(f"ties or gaps not covered: winners {first}, "
                             f"ids {ids}")
    return {"tie_first_index_wins": first, "gap_frame_ids": ids}


# K4's tie data: surface rows repeated as (first, copy), across a thread's
# 16 points (15|16, 7|8 inside them), a warp's 512 points, a
# segment (255|256, 100|356), a pass of 2048 and the whole frame (0|M-1,
# added per shape); the first must win
K4_TIES = ((7, 8), (15, 16), (100, 356), (255, 256), (511, 512),
           (1023, 1024), (2047, 2048))
# (N, M) of the cases: N across a warp and a query chunk of 32 (31, 32, 33)
# and over several chunks (67, 97), M across a segment and a pass (255,
# 257, 2048, 4100)
K4_TIE_SHAPES = ((1, 1), (31, 255), (32, 257), (33, 2048), (67, 2048),
                 (97, 257), (67, 4100))


def k4_ties(M: int) -> list:
    """The (first, copy) pairs of `K4_TIES` and (0, M-1) that fit in M
    points, each copy used once."""
    pairs, copies = [], set()
    for src, dst in K4_TIES + ((0, M - 1),):
        if src < dst < M and dst not in copies and src not in copies:
            pairs.append((src, dst))
            copies.add(dst)
    return pairs


def k4_tie_frames(seed: int = SEED + 17) -> list:
    """[(a [2, N, 3], b [2, M, 3])] float32 numpy, one case per
    `K4_TIE_SHAPES`.  Frame 0: the surface rows of `k4_ties(M)` repeated,
    with the queries 1e-3 m off the first rows, so each tie's first index
    must win; frame 1: every query sits on one surface point."""
    rng = np.random.default_rng(seed)
    cases = []
    for N, M in K4_TIE_SHAPES:
        b = rng.standard_normal((2, M, 3)) * 0.3
        pairs = k4_ties(M)
        for src, dst in pairs:
            b[0, dst] = b[0, src]
        firsts = [src for src, _ in pairs] or [0]
        a = np.empty((2, N, 3))
        a[0] = b[0, np.resize(firsts, N)] \
            + rng.standard_normal((N, 3)) * 1e-3
        a[1] = b[1, rng.integers(M)]
        cases.append(tuple(x.astype(np.float32) for x in (a, b)))
    return cases


def _k4_ties(nn) -> dict:
    """K4 against its plain version on `k4_tie_frames`, bit for bit: the
    first index of every tie wins, at every N and M of the cases."""
    wins = {}
    for (N, M), (a, b) in zip(K4_TIE_SHAPES, k4_tie_frames()):
        a, b = (torch.from_numpy(x).to(DEV) for x in (a, b))
        want = nn.nearest_neighbor_plain(a, b)
        _equal_parts(f"K4 ties at N={N}, M={M}", nn.nearest_neighbor_cuda(
            a, b), want)
        got = set(want[1][0].tolist())
        pairs = k4_ties(M)
        if got & {dst for _, dst in pairs} or not {
                src for src, _ in pairs} <= got:
            raise AssertionError(f"K4 ties at N={N}, M={M} not covered: "
                                 f"winners {sorted(got)}, pairs {pairs}")
        wins[f"{N}x{M}"] = len(pairs)
    return {"ties_first_index_wins_by_case": wins}


def issue_floor_ms(n_ops: int, n_bytes: int = 0) -> float:
    """The least ms of ``n_ops`` separately rounded f32 instructions on the
    card, and never less than its byte time."""
    return max(n_ops / F32_INSTR_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3


def _device_ms_by_kernel(fn, calls: int = 5) -> dict:
    """Device ms a call of ``fn`` for each CUDA kernel it launches, by
    torch.profiler over ``calls`` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel)", e.name)
            name = m.group(1) if m else e.name[:40]
            by[name] = by.get(name, 0.0) + e.device_time / 1e3 / calls
    return by


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
    launched = nn._signed_nearest_pruned_launch(a, b, n, delta)
    k2, prologue = launched[:3], launched[3:]  # prologue: flags, count, ids
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

    # K2's prologue against the plain flags and compaction
    flags = nn.segment_flags(a, b, delta)
    count, ids = nn.segment_list_plain(flags)
    if not all(map(torch.equal, prologue, (flags, count, ids))):
        raise AssertionError("K2's prologue differs from segment_flags and "
                             "segment_list_plain")
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
            "bound_ms": bound_ms, "bound_by": bound_by,
            "issue_floor_ms": issue_floor_ms(NN_INSTR_PER_PAIR * pairs[name],
                                             n_bytes[name]),
            "pairs": pairs[name],
            "bytes": n_bytes[name], "max_abs_err": err[name],
            "library_ms": None if library is None else cuda_ms(library)}
    # the registers, spills and waves of the sweep of K2 (FULL = false) and
    # of K3 (FULL = true), T threads of Q queries a block, and of K4's
    # kernel, T threads a block and one block a frame
    for e in _build_report(nn.SOURCE):
        m = re.search(r"signed_sweep_kernelILi(\d+)ELi(\d+)ELi\d+ELb([01])E",
                      e["kernel"])
        if m:
            T, Q = int(m.group(1)), int(m.group(2))
            out["K3" if m.group(3) == "1" else "K2"]["ptxas"] = _occupancy(
                e, T, F * -(-N // (T * Q)))
        m = re.search(r"nearest_kernelILi(\d+)E", e["kernel"])
        if m:
            out["K4"]["ptxas"] = _occupancy(e, int(m.group(1)), F_all)

    # one call of each captured in a CUDA graph: one launch, replay equals
    # eager
    captures = {}
    for name, key, call, want in (
            ("K2", "signed_nearest_pruned",
             lambda: nn.signed_nearest_pruned_cuda(a, b, n, delta), k2),
            ("K3", "signed_nearest",
             lambda: nn.signed_nearest_cuda(a, b, n), k3),
            ("K4", "nearest_neighbor",
             lambda: nn.nearest_neighbor_cuda(a4, cloud), k4)):
        captures[name], graph = _graph_capture(
            name, call, lambda: nn.launches[key], tuple(want))
        out[name]["graph_replay_ms"] = cuda_ms(graph.replay)
        del graph
    out["K2"]["device_ms_by_kernel"] = _device_ms_by_kernel(
        lambda: nn.signed_nearest_pruned_cuda(a, b, n, delta))
    # the same flags as plain PyTorch launches, K2's route before its prologue
    out["K2"]["segment_flags_device_ms"] = sum(_device_ms_by_kernel(
        lambda: nn.segment_flags(a, b, delta)).values())

    emit({"phase": "kernels", "gpu": gpu, "kernels": "K2 K3 K4",
          "shape_k2_k3": [F, N, M], "shape_k4": [F_all, a4.shape[1], N],
          "delta": delta, "segment": nn.SEGMENT, "bitwise_equal": True,
          "k2_equals_k3_inside_delta_forced_beyond": True,
          "flagged_segment_share": float(flags.float().mean()),
          "flagged_pair_share": pairs["K2"] / pairs["K3"],
          "rows": rows, "rows_held_against_plain": rows_sub,
          "edge_rows_bitwise_equal": _nn_edge_rows(nn),
          "k2_k3_ties_and_gaps_bitwise_equal": _k2_k3_ties_and_gaps(nn),
          "k4_ties_bitwise_equal": _k4_ties(nn),
          "k2_prologue_equals_segment_flags": True,
          "graph_capture": captures, **out})
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
    from interdiff_torch.config import CorrectionConfig, build_smpl_body

    projector = CorrectionConfig().build_model()
    projector.load_state_dict(seeded_state(projector, SEED + 7), strict=True)
    return (rest_pose_mdm(), projector,
            build_smpl_body(seed=SEED, num_verts=VERTS))


def rest_pose_mdm(future_len: int = FUTURE):
    """`MDMSmpl` defaults (``future_len`` future frames) with seeded
    weights, its two output layers scaled to a twentieth and biased to the
    rest pose with the object 0.25 m to the side of the body's centre (see
    `full_width_models`)."""
    from interdiff_torch.config import SmplTrackConfig

    model = SmplTrackConfig(future_len=future_len).build_model()
    model.load_state_dict(seeded_state(model, SEED + 1), strict=True)
    identity6d = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    with torch.no_grad():
        for layer, bias in (
                (model.bodyFinalLinear, identity6d * 22 + [0.0, 0.0, 0.0]),
                (model.objFinalLinear, identity6d + [0.25, 0.1, 0.0])):
            layer.weight.mul_(0.05)
            layer.bias.copy_(torch.tensor(bias))
    return model


BEHAVE_CATEGORIES = ("backpack", "chairwood", "boxlarge", "yogaball")


@contextlib.contextmanager
def _chumpy_stub():
    """Modules `chumpy` and `chumpy.ch` with a class `Ch` holding its array
    as ``x``, so that a pickle names the class as the SMPL-H model files
    do; the previous entries of `sys.modules` come back afterwards."""
    import types

    saved = {m: sys.modules.get(m) for m in ("chumpy", "chumpy.ch")}

    class Ch:
        def __init__(self, x):
            self.x = np.asarray(x)

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    chumpy, ch = types.ModuleType("chumpy"), types.ModuleType("chumpy.ch")
    ch.Ch = chumpy.Ch = Ch
    chumpy.ch = ch
    sys.modules.update({"chumpy": chumpy, "chumpy.ch": ch})
    try:
        yield Ch
    finally:
        for m, mod in saved.items():
            if mod is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = mod


def write_smplh_pkl(path: str, body) -> None:
    """``body`` (the port's `SmplModel`) as an SMPL-H model pkl in the
    official layout: chumpy arrays, a scipy-sparse `J_regressor`,
    `kintree_table` with the root's parent 2**32-1, faces `f` as uint32."""
    import pickle

    import scipy.sparse

    def host(name):
        return getattr(body, name).cpu().numpy().astype(np.float64)

    parents = body.parents.astype(np.int64)
    parents[0] = 2 ** 32 - 1
    with _chumpy_stub() as Ch:
        data = {
            "v_template": Ch(host("v_template")),
            "shapedirs": Ch(host("shapedirs")),
            "posedirs": Ch(host("posedirs")),
            "J_regressor": scipy.sparse.csc_matrix(host("j_regressor")),
            "weights": Ch(host("weights")),
            "kintree_table": np.stack(
                [parents, np.arange(len(parents), dtype=np.int64)]),
            "f": body.faces.astype(np.uint32),
            "bs_style": "lbs",
        }
        with open(path, "wb") as f:
            pickle.dump(data, f, protocol=2)


def _smooth_walk(rng, frames: int, dims: int, step: float,
                 keep: float = 0.99) -> np.ndarray:
    """[frames, dims] mean-reverting random walk, then a 9-frame moving
    average: smooth motion about 0 with a spread of about
    step / sqrt(1 - keep**2)."""
    noise = rng.standard_normal((frames, dims)) * step
    x = np.zeros((frames, dims))
    for t in range(1, frames):
        x[t] = keep * x[t - 1] + noise[t]
    pad = np.concatenate([np.repeat(x[:1], 4, 0), x, np.repeat(x[-1:], 4, 0)])
    return np.stack([pad[t:t + frames] for t in range(9)]).mean(0)


def write_behave_corpus(root: str, body, rng, *, sequences: int = 2,
                        frames: int = 1408, points: int = 2048):
    """A BEHAVE-format corpus on disk, as `data/behave.py` reads it:
    ``sequences`` train (Date01_*) and as many test (Date03_*) sequences of
    ``frames`` frames under ``<root>/sequence/<name>/`` (smpl_fit_all.npz
    poses [N,156], betas, trans; object_fit_all.npz angles, trans;
    contact.npz with the object's template points and normals [P,6], the
    per-frame contact index lists of the object and the body and the
    foot-contact joint label; info.json gender and category), and ``body``
    as ``<root>/models/SMPLH_{male,female}.pkl`` (`write_smplh_pkl`).  The
    motion is a smooth seeded walk of the pose (the yaw wider than the
    rest) and of the translation, the object walks along beside the body;
    genders alternate.  Returns (motion_path, model_path)."""
    motion_path = os.path.join(root, "sequence")
    model_path = os.path.join(root, "models")
    os.makedirs(model_path, exist_ok=True)
    for gender in ("male", "female"):
        write_smplh_pkl(os.path.join(model_path, f"SMPLH_{gender}.pkl"), body)
    V = body.num_verts
    for date, sub in (("Date01", "Sub01"), ("Date03", "Sub03")):
        for k in range(sequences):
            cat = BEHAVE_CATEGORIES[k % len(BEHAVE_CATEGORIES)]
            seq_dir = os.path.join(motion_path, f"{date}_{sub}_{cat}_{k}")
            os.makedirs(seq_dir, exist_ok=True)
            pose = np.concatenate([
                _smooth_walk(rng, frames, 3, 0.01) * [0.3, 3.0, 0.3],
                _smooth_walk(rng, frames, 63, 0.02),
                _smooth_walk(rng, frames, 90, 0.01)], axis=1)
            trans = (_smooth_walk(rng, frames, 3, 0.01, keep=0.999)
                     * [1.0, 0.05, 1.0] + [0.0, 0.9, 0.0])
            betas = np.broadcast_to(rng.standard_normal(10) * 0.5,
                                    (frames, 10))
            obj_angles = _smooth_walk(rng, frames, 3, 0.02)
            obj_trans = trans + [0.3, -0.2, 0.1] \
                + _smooth_walk(rng, frames, 3, 0.003)
            np.savez(os.path.join(seq_dir, "smpl_fit_all.npz"),
                     poses=pose.astype(np.float32),
                     betas=betas.astype(np.float32),
                     trans=trans.astype(np.float32))
            np.savez(os.path.join(seq_dir, "object_fit_all.npz"),
                     angles=obj_angles.astype(np.float32),
                     trans=obj_trans.astype(np.float32))
            contact = {
                "object_points": object_cloud(rng, 1, points)[0],
                "object_contact_vertex_label": [
                    np.sort(rng.choice(points, rng.integers(0, 40),
                                       replace=False))
                    for _ in range(frames)],
                "human_contact_vertex_label": [
                    np.sort(rng.choice(V, rng.integers(0, min(V, 40)),
                                       replace=False))
                    for _ in range(frames)],
                "foot_contact_joint_label": rng.integers(10, 12, frames),
            }
            np.savez(os.path.join(seq_dir, "contact.npz"), contact)
            with open(os.path.join(seq_dir, "info.json"), "w") as f:
                json.dump({"gender": ("male", "female")[k % 2], "cat": cat},
                          f)
    return motion_path, model_path


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
    pruned = nn._signed_nearest_pruned_launch

    def recording_pruned(a, b, n, delta):
        # keeps the prologue's count of flagged segments (no extra launch)
        out = pruned(a, b, n, delta)
        flag_shares.append(out[4].sum() / out[3].numel())
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nn._signed_nearest_pruned_launch = recording_pruned
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
        nn._signed_nearest_pruned_launch = pruned
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


# ---------------------------------------------------------------------------
# the skeleton (HO-GCN) track: no kernel of the port on its paths
# ---------------------------------------------------------------------------

SKEL_SMALL = dict(embedding_dim=32, num_heads=4, ff_size=32, num_layers=2)
SKEL_KEYS = ("skeleton", "obj_points", "poses", "zero_pose_obj")
# the full-width skeleton paths: 32 clips of 20 frames (10 past, 10 future)
SKEL_CLIPS, SKEL_FRAMES, SKEL_PAST = 32, 20, 10
NO_LAUNCHES = {k: 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6")}


def _skeleton_models(device, small: bool, seed: int = SEED):
    """`MDMSkeleton` (``small``: 2 + 2 layers, width 32; else the defaults)
    and the skeleton `ObjProjectorSkeleton` (21 joints, 10 + 10 frames) on
    ``device`` with seeded weights."""
    from interdiff_torch.config import CorrectionConfig, SkeletonTrackConfig

    model = SkeletonTrackConfig(future_len=10,
                                **(SKEL_SMALL if small else {})).build_model(
                                    device)
    projector = CorrectionConfig(track="skeleton", num_nodes=21,
                                 future_len=10).build_model(device)
    for module, s in ((model, seed), (projector, seed + 6)):
        module.load_state_dict(seeded_state(module, s), strict=True)
    return model, projector


def _skeleton_batch(rng, clips: int) -> dict:
    """One batch of `synthetic_skeleton_batches`, the eval and train entry
    points' `--synthetic` data."""
    from interdiff_torch.cli.common import synthetic_skeleton_batches

    return next(synthetic_skeleton_batches(rng, batch_size=clips,
                                           seq_len=SKEL_FRAMES, steps=1))


def _check_forecast(full: dict, batch: dict, corrected: bool,
                    frames: int) -> None:
    """Finite forecast of ``frames`` frames whose past frames are the
    batch's: the body exactly, with correction (the blend moves the past
    object as well), and the object and pose too without it."""
    parts = (("body", "skeleton"),) + (() if corrected else (
        ("obj", "obj_points"), ("pose", "poses")))
    B = batch["skeleton"].shape[0]
    for k, shape in (("body", (21, 3)), ("obj", (12, 3)), ("pose", (7,))):
        if tuple(full[k].shape) != (B, frames) + shape or not bool(
                torch.isfinite(full[k]).all()):
            raise AssertionError(f"bad forecast {k}: {tuple(full[k].shape)}")
    for k, src in parts:
        past = torch.from_numpy(batch[src][:, :SKEL_PAST]).to(full[k].device)
        if not torch.equal(full[k][:, :SKEL_PAST], past):
            raise AssertionError(f"past frames of {k} differ from gt")


def _small_skeleton_runs(device, rng_seed: int = 38):
    """The small skeleton runs on ``device``: the sampler on "10" respacing
    without and with correction (the gate at t <= 9, every 3: t = 9, 6, 3,
    0), `evaluate` with correction and one rollout, three train steps.
    Returns a dict of CPU tensors and floats."""
    from interdiff_torch.cli.eval_skeleton import evaluate
    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.eval.skeleton import (
        SkeletonEvalConfig,
        make_skeleton_sampler,
    )
    from interdiff_torch.train import trainer

    rng = np.random.default_rng(rng_seed)
    B, T = 2, SKEL_FRAMES
    batch = _skeleton_batch(rng, B)
    noise = rng.standard_normal((3, B, T, 106)).astype(np.float32)
    step_noise = rng.standard_normal((3, 10, B, T, 106)).astype(np.float32)
    ts = rng.integers(0, 1000, (3, B))
    train_noise = rng.standard_normal((3, B, T, 106)).astype(np.float32)
    on = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    model, projector = _skeleton_models(device, small=True)
    diffusion = DiffusionConfig(timestep_respacing="10").build(device)
    cfg = SkeletonEvalConfig(correction_t_max=9, correction_every=3)
    out, trace = {}, []
    for name, kwargs in (("plain", {}), ("corrected", dict(
            projector=projector, use_correction=True, trace=trace))):
        x = make_skeleton_sampler(cfg, model, diffusion, **kwargs)(
            *(on[k] for k in SKEL_KEYS),
            noise=torch.from_numpy(noise[0]).to(device),
            step_noise=torch.from_numpy(step_noise[0]).to(device))
        out[name] = x.cpu()
    out["fired"] = [e["t"] for e in trace]
    forecasts = []
    out["metrics"], _ = evaluate(
        cfg, model, diffusion, [batch], projector=projector, rollouts=1,
        noises=iter([(torch.from_numpy(noise[i]).to(device),
                      torch.from_numpy(step_noise[i]).to(device))
                     for i in (1, 2)]),
        report=lambda nb, means: None, forecasts=forecasts)
    out["forecast"] = {k: v.cpu() for k, v in forecasts[0].items()}
    step = trainer.make_skeleton_train_step(
        model, DiffusionConfig().build(device))
    state = trainer.TrainState.create(dict(model.named_parameters()),
                                      trainer.adamw(TRAIN_LR))
    out["losses"] = []
    for t, n in zip(ts, train_noise):
        state, metrics = step(state, on, t=torch.from_numpy(t).to(device),
                              noise=torch.from_numpy(n).to(device))
        out["losses"].append(float(metrics["loss"]))
    out["params"] = {k: v.detach().cpu() for k, v in
                     model.state_dict().items()}
    return out, batch


def phase_skeleton_cpu_vs_gpu(group, nn, sa, gpu: str) -> None:
    """The small skeleton runs on the card against the CPU, same seeded
    weights, noise, timesteps and batches: the uncorrected sampler within
    1e-5, the corrected one within CORRECTED_TOL, `evaluate`'s metrics
    within 1e-4, the three train steps' losses within 1e-5 and the
    parameters within 2 * steps * lr; no kernel of the port launched."""
    cpu, batch = _small_skeleton_runs("cpu")
    _reset_launches(group, nn, sa)
    cuda, _ = _small_skeleton_runs(DEV)
    torch.cuda.synchronize()
    launches = _read_launches(group, nn, sa)
    errs = {
        "sampler": float((cpu["plain"] - cuda["plain"]).abs().max()),
        "sampler_corrected": float(
            (cpu["corrected"] - cuda["corrected"]).abs().max()),
        "evaluate_metrics": max(abs(cpu["metrics"][k] - cuda["metrics"][k])
                                for k in cpu["metrics"]),
        "train_loss": max(abs(a - b) for a, b in zip(cpu["losses"],
                                                     cuda["losses"])),
        "train_params": max(float((cpu["params"][k] - cuda["params"][k])
                                  .abs().max()) for k in cpu["params"])}
    start = seeded_state(_skeleton_models("cpu", small=True)[0], SEED)
    moved = max(float((cuda["params"][k] - start[k]).abs().max())
                for k in start)
    tols = {"sampler": 1e-5, "sampler_corrected": CORRECTED_TOL,
            "evaluate_metrics": 1e-4, "train_loss": 1e-5,
            "train_params": 2 * 3 * TRAIN_LR}
    emit({"phase": "skeleton_cpu_vs_gpu", "gpu": gpu, "rows": 2,
          "frames": SKEL_FRAMES, "steps": 10, "fired_at": cuda["fired"],
          "metrics_cuda": cuda["metrics"], "losses_cuda": cuda["losses"],
          "max_abs_err": errs, "tolerance": tols,
          "largest_parameter_move": moved,
          "tolerance_reason": "summation order of the card's GEMMs and "
          "reductions, full f32 (no TF32); through the projector's "
          "6D-to-quaternion step with correction; Adam normalises a "
          "gradient that is rounding noise into a step of up to lr",
          "launches": launches})
    if cuda["fired"] != [9, 6, 3, 0] or cpu["fired"] != [9, 6, 3, 0]:
        raise AssertionError(f"skeleton gate fired at {cuda['fired']}")
    if launches != NO_LAUNCHES:
        raise AssertionError(f"the skeleton path launched {launches}")
    for k, tol in tols.items():
        if not errs[k] <= tol:
            raise AssertionError(f"skeleton {k}: card vs CPU {errs[k]} > "
                                 f"{tol}")
    if not moved > TRAIN_LR:
        raise AssertionError("skeleton train steps did not move the weights")
    for dev in (cpu, cuda):
        _check_forecast(dev["forecast"], batch, True, 2 * SKEL_FRAMES
                        - SKEL_PAST)


def _skeleton_fixed_draw_loss(model, diffusion, batch) -> float:
    """The skeleton training loss of ``batch`` on fixed timesteps and
    noise."""
    from interdiff_torch.train.losses import skeleton_diffusion_losses

    gen = torch.Generator(device=DEV).manual_seed(SEED + 22)
    with torch.no_grad():
        memory, gt = model.encode(*(batch[k] for k in SKEL_KEYS))
        t = torch.arange(gt.shape[0], device=DEV) * (
            diffusion.num_timesteps // gt.shape[0])
        noise = torch.randn(gt.shape, generator=gen, device=DEV)
        pred, target = diffusion.training_losses(
            lambda x, ts: model.denoise(x, ts, batch["zero_pose_obj"],
                                        memory), gt, t, noise=noise)
        return float(skeleton_diffusion_losses(
            pred, target, past_len=model.past_len)[0])


def phase_skeleton(group, nn, sa, gpu: str) -> dict:
    """The skeleton track's entry points at full width: `MDMSkeleton`
    defaults, the cosine 1000-step DDPM predicting x0, 32 clips of 20
    frames of `synthetic_skeleton_batches`, seeded weights.  (a) `evaluate`
    with correction (11 firings), (b) without, (c) with one rollout window,
    (d) `train(...)` for 20 steps with one validation at "25" respacing,
    (e) a 10-step corrected sampler call under torch.profiler.  Returns the
    kernels' launches of the eval and of the train path (all 0)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from interdiff_torch.cli.eval_skeleton import evaluate
    from interdiff_torch.cli.train_diffusion_skeleton import train
    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.eval.skeleton import (
        SkeletonEvalConfig,
        make_skeleton_sampler,
    )

    rng = np.random.default_rng(SEED + 30)
    model, projector = _skeleton_models(DEV, small=False, seed=SEED + 31)
    cfg, diffusion = SkeletonEvalConfig(), DiffusionConfig().build(DEV)
    batch = _skeleton_batch(rng, SKEL_CLIPS)
    common = {"phase": "skeleton", "gpu": gpu, "clips": SKEL_CLIPS,
              "frames": SKEL_FRAMES, "past": SKEL_PAST}
    launches = {}
    # warm-up: a 2-step corrected call on 2 clips (the gate fires at t = 0)
    evaluate(cfg, model, DiffusionConfig(timestep_respacing="2").build(DEV),
             [{k: v[:2] for k, v in batch.items()}], projector=projector,
             report=lambda nb, means: None)

    # -- (a) with correction, (b) without, (c) with one rollout window
    for case, corrected, rollouts in (("correction", True, 0),
                                      ("no_correction", False, 0),
                                      ("correction, --rollouts 1", True, 1)):
        gen = torch.Generator(device=DEV).manual_seed(SEED)
        trace, timings, forecasts, running = [], {}, [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches(group, nn, sa)
        t0 = time.perf_counter()
        totals, batches = evaluate(
            cfg, model, diffusion, [batch],
            projector=projector if corrected else None, rollouts=rollouts,
            generator=gen, timings=timings, trace=trace,
            forecasts=forecasts,
            report=lambda nb, means: running.append(means))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = _read_launches(group, nn, sa)
        launches[case] = launched
        fired = [e["t"] for e in trace]
        want_fired = list(range(500, -1, -50)) * (1 + rollouts) \
            if corrected else []
        frames = SKEL_FRAMES + rollouts * (SKEL_FRAMES - SKEL_PAST)
        _check_forecast(forecasts[0], batch, corrected, frames)
        if fired != want_fired or launched != NO_LAUNCHES or batches != 1 \
                or running != [totals] or not all(
                    np.isfinite(v) and v >= 0 for v in totals.values()):
            raise AssertionError(f"skeleton {case}: fired {fired}, launches "
                                 f"{launched}, metrics {totals}")
        steps = diffusion.num_timesteps * (1 + rollouts)
        hook_ms = [e["start"].elapsed_time(e["end"]) for e in trace]
        emit({**common, "path": f"evaluate, {case}", "steps": steps,
              "metrics": totals, "wall_s": wall, "part_s": timings,
              "seq_per_s": SKEL_CLIPS / wall,
              "ms_per_ddpm_step": timings["sampler"] * 1e3 / steps,
              "firings": len(fired),
              "hook_ms_per_firing_median": statistics.median(hook_ms)
              if hook_ms else None, "hook_ms": hook_ms,
              "forecast_frames": frames, "launches": launched,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})

    # -- (d) the trainer: 20 steps on one repeated batch, one validation
    train_model, _ = _skeleton_models(DEV, small=False, seed=SEED + 32)
    on_card = {k: torch.from_numpy(batch[k]).to(DEV) for k in SKEL_KEYS}
    before = _skeleton_fixed_draw_loss(train_model, diffusion, on_card)
    rec = {"loss": [], "events": []}

    def on_step(i, state, metrics):
        rec["loss"].append(metrics["loss"])
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        rec["events"].append(event)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(group, nn, sa)
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as results:
        _, summary = train(
            train_model, diffusion, lambda: [batch] * TRAIN_STEPS,
            results_dir=results, lr=TRAIN_LR, validate_every_epoch=True,
            val_diffusion=DiffusionConfig(timestep_respacing="25").build(DEV),
            generator=torch.Generator(device=DEV).manual_seed(SEED),
            on_step=on_step)
        saved = sorted(os.listdir(results))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["train"] = _read_launches(group, nn, sa)
    events = [start] + rec["events"]
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = torch.stack(rec["loss"]).tolist()
    after = _skeleton_fixed_draw_loss(train_model, diffusion, on_card)
    ms = statistics.median(step_ms[1:])
    line = {**common, "path": "train", "steps": summary["steps"],
            "lr": TRAIN_LR, "loss_first_step": losses[0],
            "loss_last_step": losses[-1], "fixed_draw_loss_before": before,
            "fixed_draw_loss_after": after,
            "ms_per_step_cuda_events_median": ms,
            "ms_first_step": step_ms[0], "steps_per_s": 1e3 / ms,
            "seq_per_s": SKEL_CLIPS * 1e3 / ms, "val": summary["val"],
            "saved": saved, "wall_s_with_validation": wall,
            "launches": launches["train"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(line)
    if summary["steps"] != TRAIN_STEPS or launches["train"] != NO_LAUNCHES \
            or not (np.isfinite(losses).all() and after < before) \
            or len(summary["val"]) != 1 or not all(
                np.isfinite(v) for v in summary["val"][0].values()) \
            or saved != ["ckpt", "metrics.jsonl"]:
        raise AssertionError(f"skeleton train: {line}")

    # -- (e) launches per DDPM step and the device's busy share
    trace = []
    run = make_skeleton_sampler(
        SkeletonEvalConfig(correction_t_max=9, correction_every=5), model,
        DiffusionConfig(timestep_respacing="10").build(DEV), projector=projector,
        use_correction=True, reuse_memory=True, trace=trace)
    memory, gt = model.encode(*(on_card[k] for k in SKEL_KEYS))
    args = tuple(on_card[k] for k in SKEL_KEYS) + (memory, gt)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    run(*args, generator=gen)  # warm-up
    torch.cuda.synchronize()
    del trace[:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*args, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events, busy_ms, top = _device_events(prof)
    emit({**common, "path": "profile, corrected sampler call", "steps": 10,
          "fired_at": [e["t"] for e in trace], "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if events else "not measured",
          "device_busy_share": busy_ms / wall_ms if events
          else "not measured",
          "kernel_launches": len(events),
          "kernel_launches_per_step": len(events) / 10,
          "top_kernels_ms": {name: us / 1e3 for name, us in top}})
    if [e["t"] for e in trace] != [5, 0]:
        raise AssertionError("skeleton profile: the gate did not fire")
    return {"skeleton_eval": {k: sum(launches[c][k] for c in launches
                                     if c != "train")
                              for k in NO_LAUNCHES},
            "skeleton_train": launches["train"]}


# ---------------------------------------------------------------------------
# correction training (both tracks) and test-time refinement

CORR_LR = 3e-4
# `cli/train_correction_smpl.py`'s defaults: 16 clips of 10 + 25 frames;
# 20 steps, 10 in the initialize phase (mean over nodes), 10 in the main
CORR_CLIPS, CORR_PAST, CORR_FUTURE, CORR_EPOCHS, CORR_INIT = 16, 10, 25, 20, 10
CORR_SKEL_CLIPS = 32  # `cli/train_correction_skeleton.py`: 32 of 10 + 10
# `cli/optimization.py`'s defaults: 8 clips of 10 + 10 frames, "100"
# respacing, 200 iterations
REFINE_CLIPS, REFINE_PAST, REFINE_FUTURE = 8, 10, 10
REFINE_RESPACING, REFINE_ITERS = "100", 200
# the small card-against-CPU runs: 3 train steps, a 5-iteration refine
# started 0.01 off its anchors
CORR_SMALL_STEPS, REFINE_SMALL_ITERS, REFINE_LR = 3, 5, 1e-3
REFINE_SHIFT = 0.01
# the refine's poses, best losses and every trace row, each against the
# larger of its size and 1
REFINE_TOL = 1e-4
REFINE_TOL_REASON = ("started 0.01 off the anchors, no gradient sits on a "
                     "kink of |x| (at the anchors FK compares with itself "
                     "and the anchors' gradients are rounding noise whose "
                     "sign Adam turns into a step of lr), so the two "
                     "devices differ by rounding alone, as the CPU test "
                     "against the JAX refiner holds at 1e-4")
# a sanity bound on the poses alone: Adam moves an entry by about lr a step
REFINE_SANITY = 2 * REFINE_SMALL_ITERS * REFINE_LR


def correction_batch(rng, body, clips: int, frames: int, points: int
                     ) -> dict:
    """One correction training batch on ``body``'s device, built by the
    port's own FK: seeded poses, the body's vertices and normals, an
    ellipsoid object cloud whose centre sits 0.2 m to the side of the body's
    centroid in every frame (straddling the surface), contact labels on the
    vertices within 0.05 m of the placed cloud (K4 on CUDA), and the 67
    markers (xyz | normal | label) picked from the vertices (their indices
    clamped to the body's last vertex, as the JAX gather clamps them)."""
    from interdiff_torch.data.constants import MARKERSET_SSM67_SMPLH
    from interdiff_torch.geometry.normals import vertex_normals
    from interdiff_torch.geometry.rotations import axis_angle_to_matrix
    from interdiff_torch.ops.signed_distance import nearest_neighbor
    from interdiff_torch.smpl.model import smpl_forward

    device = body.v_template.device
    B, T, P = clips, frames, points

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            device)

    pose = dev(np.concatenate([rng.standard_normal((B, T, 66)) * 0.3,
                               rng.standard_normal((B, T, 90)) * 0.1], -1))
    betas = dev(np.broadcast_to(rng.standard_normal((B, 1, 10)) * 0.5,
                                (B, T, 10)))
    trans = dev(rng.standard_normal((B, T, 3)) * 0.1)
    cloud = dev(object_cloud(rng, B, P))
    obj_angles = dev(rng.standard_normal((B, T, 3)) * 0.5)
    with torch.no_grad():
        verts = smpl_forward(body, pose.reshape(B * T, -1),
                             betas.reshape(B * T, -1),
                             trans.reshape(B * T, 3))[0]
        normals = vertex_normals(verts, body.faces_idx, body.incident)
        obj_trans = verts.reshape(B, T, -1, 3).mean(dim=2) + torch.tensor(
            [0.2, 0.0, 0.0], device=device)
        placed = (torch.einsum("btij,bpj->btpi",
                               axis_angle_to_matrix(obj_angles),
                               cloud[..., :3]) + obj_trans[:, :, None])
        h2o, _ = nearest_neighbor(verts, placed.reshape(B * T, P, 3))
        label = (h2o < 0.05 ** 2).to(torch.float32)[..., None]
        human = torch.cat([verts, normals, label], -1).reshape(B, T, -1, 7)
    idx = np.minimum(MARKERSET_SSM67_SMPLH, body.num_verts - 1)
    return {"obj_angles": obj_angles, "obj_trans": obj_trans.contiguous(),
            "markers": human[:, :, torch.from_numpy(idx.astype(
                np.int64)).to(device)].contiguous(),
            "human_verts": human.contiguous(), "obj_points": cloud}


@contextlib.contextmanager
def _plain_nn(nn):
    """K3's and K4's `autograd.Function`s swapped for their plain versions,
    whose gradient autograd takes through the sweep: the consumer's
    gradient through the kernels can then be held against autograd's."""
    saved = nn.nearest_neighbor_diff, nn.signed_nearest_diff
    nn.nearest_neighbor_diff = nn.nearest_neighbor_plain
    nn.signed_nearest_diff = nn.signed_nearest_plain
    try:
        yield
    finally:
        nn.nearest_neighbor_diff, nn.signed_nearest_diff = saved


def _consumer_grads(nn, loss_fn, leaves: dict, want_launches: dict) -> dict:
    """The gradient of ``loss_fn()`` with respect to ``leaves`` through the
    kernels (they must launch as ``want_launches`` says) against autograd
    through the plain versions, each relative to the largest entry of its
    gradient; raises beyond GRAD_TOL (K3's and K4's)."""
    before = dict(nn.launches)
    got = torch.autograd.grad(loss_fn(), list(leaves.values()))
    launched = {k: nn.launches[k] - before[k] for k in want_launches}
    if launched != want_launches:
        raise AssertionError(f"the consumer launched {launched}")
    before = dict(nn.launches)
    with _plain_nn(nn):
        want = torch.autograd.grad(loss_fn(), list(leaves.values()))
    if nn.launches != before:
        raise AssertionError("a kernel ran in the plain consumer")
    errs = {}
    for label, g, w in zip(leaves, got, want):
        rel = float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
        errs[label] = rel
        if not rel <= GRAD_TOL["K3"] or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"consumer gradient of {label}: {rel} from "
                                 f"autograd through the plain versions")
    return errs


def _correction_projectors(device, small: bool):
    """The SMPL and skeleton projectors on ``device`` with seeded weights:
    the CLIs' defaults, or (``small``) 4 past and 8 future frames."""
    from interdiff_torch.models.correction import (
        ObjProjectorSkeleton,
        ObjProjectorSmpl,
    )

    kw = (dict(past_len=4, future_len=8) if small else
          dict(past_len=CORR_PAST, future_len=CORR_FUTURE))
    smpl = ObjProjectorSmpl(n_pre=6 if small else 10, **kw, device=device)
    skel = ObjProjectorSkeleton(
        **(kw if small else dict(past_len=SKEL_PAST, future_len=SKEL_PAST)),
        device=device)
    for module, s in ((smpl, SEED + 40), (skel, SEED + 41)):
        module.load_state_dict(seeded_state(module, s), strict=True)
    return smpl, skel


def _small_correction_runs(device, batches, skel_batches, draws, clips,
                           body_seed: int):
    """On ``device``: three steps of each correction trainer (SMPL through
    the initialize phase, then the main phase with the given marker draws)
    and a 5-iteration refine of ``clips`` on a 256-vertex stand-in body,
    every parameter moved REFINE_SHIFT off its anchor by one seeded draw.
    Returns CPU tensors and floats."""
    from interdiff_torch.config import build_smpl_body
    from interdiff_torch.eval.optimization import (OptimConfig, descend,
                                                   refiner_init)
    from interdiff_torch.train import trainer

    def on(d):
        return {k: torch.as_tensor(v).to(device) for k, v in d.items()}

    smpl_p, skel_p = _correction_projectors(device, small=True)
    out = {"smpl_losses": [], "skeleton_losses": []}
    state = trainer.CorrectionTrainState.create(smpl_p, trainer.adam(CORR_LR))
    steps = {p: trainer.make_correction_smpl_train_step(smpl_p, initialize=p)
             for p in (True, False)}
    for i, (batch, draw) in enumerate(zip(batches, draws)):
        state, m = steps[i == 0](state, on(batch), epoch=8.0 + 6 * i,
                                 marker_idx=torch.as_tensor(draw).to(device))
        out["smpl_losses"].append(float(m["loss"]))
    state = trainer.CorrectionTrainState.create(skel_p, trainer.adam(CORR_LR))
    step = trainer.make_correction_skeleton_train_step(skel_p)
    for batch in skel_batches:
        state, m = step(state, on(batch))
        out["skeleton_losses"].append(float(m["loss"]))
    out["smpl_state"] = {k: v.cpu() for k, v in smpl_p.state_dict().items()}
    out["skeleton_state"] = {k: v.cpu()
                             for k, v in skel_p.state_dict().items()}
    body = build_smpl_body(seed=body_seed, num_verts=256, device=device)
    cfg = OptimConfig(iters=REFINE_SMALL_ITERS, keep_after=2)
    params, aux = refiner_init(body, cfg, **on(clips))
    shift_rng = np.random.default_rng(SEED + 49)
    with torch.no_grad():
        for k in sorted(params):
            params[k].add_(torch.from_numpy((shift_rng.standard_normal(
                tuple(params[k].shape)) * REFINE_SHIFT).astype(np.float32))
                .to(device))
    refined = descend(body, cfg, params, aux)
    out["refined"] = {k: v.cpu() for k, v in refined.items()}
    return out


def phase_correction_cpu_vs_gpu(gpu: str) -> None:
    """The small correction train steps of both tracks and a small refine
    on the card against the CPU, from the same weights, batches and marker
    draws: the loss of every step within 1e-5, the parameters and the
    BatchNorm statistics within 2 * steps * lr (a bias in front of a
    BatchNorm in train mode has a zero gradient that each device rounds
    differently, and Adam steps it by up to lr all the same; the running
    mean carries that bias); the refined poses, the best losses and every
    row of the trace within REFINE_TOL of the larger of their size and 1
    (reason in the line), and the poses within REFINE_SANITY."""
    from interdiff_torch.cli.common import synthetic_skeleton_batches
    from interdiff_torch.config import build_smpl_body

    rng = np.random.default_rng(SEED + 42)
    body_seed = SEED + 43
    cpu_body = build_smpl_body(seed=body_seed, num_verts=256, device="cpu")
    batches = [{k: v.numpy() for k, v in correction_batch(
        rng, cpu_body, 2, 12, 64).items()} for _ in range(CORR_SMALL_STEPS)]
    draws = [rng.integers(0, 67, 2) for _ in range(CORR_SMALL_STEPS)]
    skel_batches = [{k: b[k] for k in ("skeleton", "poses")} for b in
                    synthetic_skeleton_batches(rng, batch_size=2, seq_len=12,
                                               steps=CORR_SMALL_STEPS)]
    T = 8
    clips = {"body_pose": rng.standard_normal((2, T, 66)) * 0.2,
             "hand_pose": rng.standard_normal((2, T, 90)) * 0.05,
             "body_trans": rng.standard_normal((2, T, 3)) * 0.02,
             "betas": rng.standard_normal((2, T, 10)) * 0.1,
             "obj_angles": rng.standard_normal((2, T, 3)) * 0.3,
             "obj_trans": np.array([0.2, 0.0, 0.0])
             + rng.standard_normal((2, T, 3)) * 0.02,
             "obj_points": rng.standard_normal((2, 64, 3)) * 0.06}
    clips = {k: np.asarray(v, np.float32) for k, v in clips.items()}
    runs = {d: _small_correction_runs(d, batches, skel_batches, draws, clips,
                                      body_seed) for d in ("cpu", DEV)}
    cpu, card = runs["cpu"], runs[DEV]
    line = {"phase": "correction_cpu_vs_gpu", "gpu": gpu,
            "steps": CORR_SMALL_STEPS, "lr": CORR_LR,
            "loss_tolerance": 1e-5, "state_tolerance":
            2 * CORR_SMALL_STEPS * CORR_LR}
    ok = True
    for track in ("smpl", "skeleton"):
        loss_err = max(abs(a - b) for a, b in zip(
            cpu[f"{track}_losses"], card[f"{track}_losses"]))
        params = {k for k in cpu[f"{track}_state"]
                  if not k.endswith(("running_mean", "running_var"))}
        diff = {k: float((cpu[f"{track}_state"][k] - card[f"{track}_state"][k])
                         .abs().max()) for k in cpu[f"{track}_state"]}
        p_err = max(diff[k] for k in params)
        s_err = max(v for k, v in diff.items() if k not in params)
        line[track] = {"losses_cuda": card[f"{track}_losses"],
                       "loss_max_abs_err": loss_err,
                       "param_max_abs_diff": p_err,
                       "stat_max_abs_diff": s_err}
        ok &= (loss_err <= 1e-5 and max(p_err, s_err)
               <= 2 * CORR_SMALL_STEPS * CORR_LR)
    rc, rg = cpu["refined"], card["refined"]
    poses = ("pose", "trans", "obj_angles", "obj_trans")

    def rel(k):
        return float(((rg[k] - rc[k]).abs() / rc[k].abs().clamp(min=1.0))
                     .max())

    rel_err = {k: rel(k) for k in poses + ("best_loss", "terms")}
    pose_err = max(float((rc[k] - rg[k]).abs().max()) for k in poses)
    finite = all(bool(torch.isfinite(rg[k]).all()) for k in rg)
    line["refine"] = {
        "iters": REFINE_SMALL_ITERS, "lr": REFINE_LR, "clips": 2,
        "start_off_anchors": REFINE_SHIFT,
        "max_rel_diff": rel_err, "tolerance": REFINE_TOL,
        "refined_max_abs_diff": pose_err, "sanity_bound": REFINE_SANITY,
        "best_loss_cuda": rg["best_loss"].tolist(),
        "tolerance_reason": REFINE_TOL_REASON}
    emit(line)
    ok &= (max(rel_err.values()) <= REFINE_TOL and pose_err <= REFINE_SANITY
           and finite)
    if not ok:
        raise AssertionError("correction: card vs CPU out of tolerance")


def _nn_at(nn, name: str, a, b, n=None, *, plain_frames: int = 16,
           library=None, library_calls: int = 1) -> dict:
    """K3 (with ``n``) or K4 at the shape of a consumer of this slice:
    bitwise against its plain version on the first ``plain_frames``
    frames, the kernel's time by CUDA events, the plain version's on those
    frames, the bound of the whole call and, for K4, the library's time
    (``library_calls`` calls that together cover the frames)."""
    F, N, _ = a.shape
    M = b.shape[1]
    if n is None:
        kernel = (lambda: nn.nearest_neighbor_cuda(a, b))
        plain_in = (a[:plain_frames], b[:plain_frames])
        plain = (lambda: nn.nearest_neighbor_plain(*plain_in))
        n_bytes = 4 * (3 * F * N + 3 * F * M + 2 * F * N)
    else:
        kernel = (lambda: nn.signed_nearest_cuda(a, b, n))
        plain_in = (a[:plain_frames], b[:plain_frames], n[:plain_frames])
        plain = (lambda: nn.signed_nearest_plain(*plain_in))
        n_bytes = 4 * (3 * F * N + 6 * F * M + 3 * F * N)
    got = kernel()
    err = _equal_parts(name, tuple(x[:plain_frames] for x in got), plain())
    bound_ms, bound_by = _nn_bound(F * N * M, n_bytes)
    return {"frames": F, "queries": N, "points": M, "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain, runs=5), "plain_frames": plain_frames,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
            "library_ms": None if library is None
            else cuda_ms(library, runs=5), "library_calls": library_calls}


def _correction_fixed_loss(projector, batch) -> dict:
    """The SMPL correction loss of ``batch`` in the main phase at full
    annealing, the first maximum as the marker, on a copy of the projector
    (train mode moves the running statistics): the total and the pose
    terms' sum."""
    import copy

    from interdiff_torch.train import trainer
    from interdiff_torch.train.losses_correction import correction_smpl_losses

    p = copy.deepcopy(projector)
    with torch.no_grad():
        obj_gt, contact = trainer.correction_smpl_inputs(batch, p.past_len)
        pred = p.sample(obj_gt, batch["markers"][..., :3], contact,
                        train=True, marker_idx=(contact + p.hand_bias)
                        .argmax(dim=-1))
        loss, terms = correction_smpl_losses(
            pred, obj_gt, past_len=p.past_len,
            obj_points=batch["obj_points"], human_verts=batch["human_verts"],
            epoch=float(CORR_EPOCHS))
    return {"loss": float(loss), "pose_terms": float(sum(
        v for k, v in terms.items() if k.startswith("obj_")))}


def _timed_train(run, group, nn, sa) -> dict:
    """``run(on_step)`` (a trainer's ``train``, which returns its state and
    summary) between a reset and a read of the launches, with a CUDA event
    after every step: the launches, ms per step, the losses, wall s and
    peak memory."""
    rec = {"loss": [], "events": []}

    def on_step(i, state, metrics):
        rec["loss"].append(metrics["loss"])
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        rec["events"].append(event)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(group, nn, sa)
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    _, summary = run(on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _read_launches(group, nn, sa)
    events = [start] + rec["events"]
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return {"summary": summary, "launches": launched, "step_ms": step_ms,
            "losses": torch.stack(rec["loss"]).tolist(), "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def phase_correction_train(group, nn, sa, body, gpu: str) -> tuple:
    """Both correction trainers' `train(...)` at full width.  SMPL: the
    CLI's defaults (16 clips of 10 + 25 frames, `ObjProjectorSmpl()`
    defaults, 67 markers) on batches of the V=6890 stand-in body with
    2048-point clouds (`correction_batch`), 20 steps, 10 in the initialize
    phase and 10 in the main one; K3 and K4 forward and backward once a
    step, K3 and K4 at these shapes against their plain versions (K4 at
    N=6890 queries, whose last chunk of 32 is ragged) with times and
    bounds, and the loss's gradient through them against autograd through
    the plain versions on 2 clips.  Skeleton: 20 steps of 32 clips of 10 +
    10 frames, no kernel.  Returns (launches by path, K3's and K4's
    records)."""
    import tempfile

    from interdiff_torch.cli import train_correction_skeleton as cli_skel
    from interdiff_torch.cli import train_correction_smpl as cli_smpl
    from interdiff_torch.geometry.rotations import rotation_6d_to_matrix
    from interdiff_torch.train.losses_correction import (
        contact_penetration_terms,
    )
    from interdiff_torch.train.trainer import correction_smpl_inputs

    rng = np.random.default_rng(SEED + 44)
    frames = CORR_PAST + CORR_FUTURE
    batch = correction_batch(rng, body, CORR_CLIPS, frames, POINTS)
    F = CORR_CLIPS * frames
    verts = batch["human_verts"][..., :3].reshape(F, -1, 3).contiguous()
    normals = batch["human_verts"][..., 3:6].reshape(F, -1, 3).contiguous()
    obj_gt, _ = correction_smpl_inputs(batch, CORR_PAST)
    placed = (torch.einsum("btij,bpj->btpi",
                           rotation_6d_to_matrix(obj_gt[..., :6]),
                           batch["obj_points"][..., :3])
              + obj_gt[..., None, 6:]).reshape(F, POINTS, 3).contiguous()
    quarter = F // 4
    records = {
        "K4": _nn_at(nn, "K4 at N=6890", verts, placed,
                     library=lambda: [torch.cdist(
                         verts[s:s + quarter], placed[s:s + quarter])
                         .square().min(dim=-1) for s in range(0, F,
                                                              quarter)],
                     library_calls=4),
        "K3": _nn_at(nn, "K3 at the correction loss's shape", placed, verts,
                     normals)}
    if verts.shape[1] % 32 == 0:
        raise AssertionError("K4's queries fill whole chunks")
    labelled = float(batch["human_verts"][..., 6].mean())

    # the loss's gradient through K3 and K4 inside the consumer
    sub = {k: v[:2] for k, v in batch.items()}
    obj_gt2, _ = correction_smpl_inputs(sub, CORR_PAST)
    lrng = np.random.default_rng(SEED + 45)
    pred = (obj_gt2 + torch.from_numpy((lrng.standard_normal(
        tuple(obj_gt2.shape)) * 0.02).astype(np.float32)).to(DEV)
            ).requires_grad_(True)
    terms = {}

    def consumer():
        c, p = contact_penetration_terms(pred, sub["obj_points"],
                                         sub["human_verts"])
        terms.update(contact=float(c.detach()), penetration=float(
            p.detach()))
        return c + p

    grad_err = _consumer_grads(nn, consumer, {"obj_pred": pred},
                               {"signed_nearest": 1, "nearest_neighbor": 1})
    if not (terms["contact"] > 0 and terms["penetration"] > 0):
        raise AssertionError(f"the consumer's terms do no work: {terms}")

    smpl_p, skel_p = _correction_projectors(DEV, small=False)
    before = _correction_fixed_loss(smpl_p, batch)
    with tempfile.TemporaryDirectory() as results:
        smpl = _timed_train(lambda on_step: cli_smpl.train(
            smpl_p, lambda: [batch], results_dir=results,
            epochs=CORR_EPOCHS, lr=CORR_LR, initialize_epochs=CORR_INIT,
            generator=torch.Generator(device=DEV).manual_seed(SEED),
            on_step=on_step), group, nn, sa)
        saved = sorted(os.listdir(os.path.join(results, "ckpt")))
    after = _correction_fixed_loss(smpl_p, batch)
    want = {**NO_LAUNCHES, "K3": CORR_EPOCHS, "K4": CORR_EPOCHS}
    ms = smpl["step_ms"]
    line = {"phase": "correction_train", "gpu": gpu, "track": "smpl",
            "clips": CORR_CLIPS, "frames": frames, "past": CORR_PAST,
            "points": POINTS, "verts": int(verts.shape[1]), "markers": 67,
            "steps": smpl["summary"]["steps"],
            "initialize_steps": CORR_INIT, "lr": CORR_LR,
            "labelled_contact_vertex_share": labelled,
            "loss_first_step": smpl["losses"][0],
            "loss_last_step": smpl["losses"][-1],
            "fixed_draw_loss_before": before, "fixed_draw_loss_after": after,
            "ms_per_step_cuda_events_median": statistics.median(ms[1:]),
            "ms_per_step_initialize_phase_median": statistics.median(
                ms[1:CORR_INIT]),
            "ms_per_step_main_phase_median": statistics.median(
                ms[CORR_INIT:]),
            "ms_first_step": ms[0], "wall_s": smpl["wall_s"],
            "launches": smpl["launches"],
            "launches_per_step": {k: v / CORR_EPOCHS
                                  for k, v in smpl["launches"].items()},
            "consumer_gradient_vs_plain": grad_err,
            "consumer_terms_on_2_clips": terms,
            "gradient_tolerance": GRAD_TOL["K3"],
            "kernels_at_this_shape": records, "saved": saved,
            "peak_mem_gb": smpl["peak_mem_gb"]}
    emit(line)
    if smpl["launches"] != want or smpl["summary"]["steps"] != CORR_EPOCHS \
            or not np.isfinite(smpl["losses"]).all() \
            or not after["pose_terms"] < before["pose_terms"] \
            or saved != ["index.json", f"step_{CORR_EPOCHS}.pt"]:
        raise AssertionError(f"correction train (SMPL): {line}")

    skel_batch = {k: v for k, v in _skeleton_batch(
        np.random.default_rng(SEED + 46), CORR_SKEL_CLIPS).items()
        if k in ("skeleton", "poses")}
    with tempfile.TemporaryDirectory() as results:
        skel = _timed_train(lambda on_step: cli_skel.train(
            skel_p, lambda: [skel_batch] * TRAIN_STEPS, results_dir=results,
            lr=CORR_LR, on_step=on_step), group, nn, sa)
    ms = skel["step_ms"]
    line = {"phase": "correction_train", "gpu": gpu, "track": "skeleton",
            "clips": CORR_SKEL_CLIPS, "frames": SKEL_FRAMES,
            "steps": skel["summary"]["steps"], "lr": CORR_LR,
            "loss_first_step": skel["losses"][0],
            "loss_last_step": skel["losses"][-1],
            "ms_per_step_cuda_events_median": statistics.median(ms[1:]),
            "ms_first_step": ms[0], "wall_s": skel["wall_s"],
            "launches": skel["launches"], "peak_mem_gb": skel["peak_mem_gb"]}
    emit(line)
    if skel["launches"] != NO_LAUNCHES or not np.isfinite(
            skel["losses"]).all() or not skel["losses"][-1] < \
            skel["losses"][0] or skel["summary"]["steps"] != TRAIN_STEPS:
        raise AssertionError(f"correction train (skeleton): {line}")
    return ({"correction_train_smpl": smpl["launches"],
             "correction_train_skeleton": skel["launches"]}, records)


def phase_refine(group, nn, sa, body, gpu: str) -> tuple:
    """`cli/optimization.py`'s generate-then-refine path at full width: the
    rest-pose `MDMSmpl` of 10 + 10 frames, 8 clips with 2048-point clouds,
    "100" respacing, 200 iterations on the V=6890 stand-in body: the seconds
    of sampling, penetration and refinement, ms per iteration, launches
    (K1 2 for the encode, K2 2 for the penetration before and after, K3 and
    K4 one an iteration), the penetration before and after, every trace
    term finite; K3 and K4 at the refiner's shapes; the refiner's gradient
    through K3 (queries, surface and normals) against autograd through the
    plain versions on one clip.  Returns (launches, K3's and K4's
    records)."""
    import tempfile

    from interdiff_torch.cli.optimization import generate_and_refine
    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.eval.optimization import (
        OptimConfig,
        TERM_NAMES,
        refiner_init,
        refiner_loss,
    )
    from interdiff_torch.eval.smpl_short import SmplEvalConfig
    from interdiff_torch.geometry.normals import vertex_normals
    from interdiff_torch.geometry.rotations import axis_angle_to_matrix
    from interdiff_torch.smpl.model import smpl_forward

    rng = np.random.default_rng(SEED + 47)
    frames = REFINE_PAST + REFINE_FUTURE
    model = rest_pose_mdm(REFINE_FUTURE)
    cfg = SmplEvalConfig(past_len=REFINE_PAST, future_len=REFINE_FUTURE)
    diffusion = DiffusionConfig(timestep_respacing=REFINE_RESPACING).build(
        DEV)
    ocfg = OptimConfig(iters=REFINE_ITERS, keep_after=150)
    batch = _main_path_batch(rng, REFINE_CLIPS, frames, POINTS)
    # warm-up: 2 respaced steps and 3 iterations on 2 clips
    with tempfile.TemporaryDirectory() as out_dir:
        generate_and_refine(
            cfg, model, DiffusionConfig(timestep_respacing="2").build(DEV),
            body, [{k: v[:2] for k, v in batch.items()}],
            OptimConfig(iters=3, keep_after=1), out_dir=out_dir)
    timings, outputs = {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(group, nn, sa)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        summary = generate_and_refine(
            cfg, model, diffusion, body, [batch], ocfg, out_dir=out_dir,
            generator=torch.Generator(device=DEV).manual_seed(SEED),
            timings=timings, outputs=outputs,
            extra={"respacing": REFINE_RESPACING})
        written = sorted(os.listdir(out_dir))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _read_launches(group, nn, sa)
    want = {**NO_LAUNCHES, "K1": 2, "K2": 2, "K3": REFINE_ITERS,
            "K4": REFINE_ITERS}
    refined = outputs[0]
    terms = refined["terms"]  # [clips, iters, terms]
    finite = {name: bool(torch.isfinite(terms[..., j]).all())
              for j, name in enumerate(TERM_NAMES)}

    # K3 and K4 at the refiner's shapes, on the refined clips
    F = REFINE_CLIPS * frames
    betas = torch.from_numpy(batch["body_betas"]).to(DEV)
    obj_points = torch.from_numpy(batch["obj_points"][..., :3]).to(DEV)
    with torch.no_grad():
        verts = smpl_forward(body, refined["pose"].reshape(F, -1),
                             betas.reshape(F, -1),
                             refined["trans"].reshape(F, 3))[0]
        normals = vertex_normals(verts, body.faces_idx, body.incident)
        pts = (torch.einsum("cpj,ctij->ctpi", obj_points,
                            axis_angle_to_matrix(refined["obj_angles"]))
               + refined["obj_trans"][:, :, None]).reshape(F, POINTS, 3)
    records = {"K3": _nn_at(nn, "K3 at the refiner's shape",
                            pts.contiguous(), verts, normals),
               "K4": _nn_at(nn, "K4 at the refiner's shape", verts,
                            pts.contiguous(),
                            library=lambda: torch.cdist(
                                verts, pts.contiguous()).square()
                            .min(dim=-1))}
    # the refiner's gradient through K3 on clip 0, 0.01 off the refined
    # parameters (off the kinks of |x|)
    params, aux = refiner_init(
        body, ocfg, body_pose=refined["pose"][:1, :, :66],
        hand_pose=refined["pose"][:1, :, 66:], body_trans=refined["trans"][:1],
        betas=betas[:1], obj_angles=refined["obj_angles"][:1],
        obj_trans=refined["obj_trans"][:1], obj_points=obj_points[:1])
    lrng = np.random.default_rng(SEED + 48)
    one = {k: (v + torch.from_numpy((lrng.standard_normal(tuple(v.shape))
                                     * 0.01).astype(np.float32)).to(DEV)
               ).requires_grad_(True) for k, v in params.items()}
    grad_err = _consumer_grads(
        nn, lambda: refiner_loss(body, ocfg, one, 1.0, aux)[0].sum(), one,
        {"signed_nearest": 1, "nearest_neighbor": 1})

    line = {"phase": "refine", "gpu": gpu, "clips": REFINE_CLIPS,
            "frames": frames, "past": REFINE_PAST, "points": POINTS,
            "verts": body.num_verts, "respacing": REFINE_RESPACING,
            "iters": REFINE_ITERS, "summary": summary, "wall_s": wall,
            "part_s": timings,
            "ms_per_refine_iteration": timings["refine"] * 1e3
            / REFINE_ITERS, "launches": launched,
            "launches_per_iteration": {"K3": launched["K3"] / REFINE_ITERS,
                                       "K4": launched["K4"] / REFINE_ITERS},
            "best_loss": refined["best_loss"].tolist(),
            "trace_first_iteration": dict(zip(
                TERM_NAMES, terms[:, 0].mean(dim=0).tolist())),
            "trace_last_iteration": dict(zip(
                TERM_NAMES, terms[:, -1].mean(dim=0).tolist())),
            "trace_terms_finite": finite,
            "consumer_gradient_vs_plain": grad_err,
            "gradient_tolerance": GRAD_TOL["K3"],
            "kernels_at_this_shape": records, "written": written,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(line)
    if launched != want or not all(finite.values()) or written != [
            "refined_1.npz", "summary.json"] or not all(
            np.isfinite(summary[k]) for k in (
                "penetrate_before", "penetrate_after", "depth_before",
                "depth_after")) or not bool(
            torch.isfinite(refined["best_loss"]).all()):
        raise AssertionError(f"refine: {line}")
    return launched, records


# the BEHAVE phases: 2 train and 2 test sequences of 1,408 frames (the
# length of BEHAVE's Date01_Sub01_backpack_back), 2048 points a template
BEHAVE_SEQUENCES, BEHAVE_FRAMES = 2, 1408
BEHAVE_EVAL_RESPACING, BEHAVE_DIVERSE = "100", 4
BEHAVE_TRAIN_STEPS, BEHAVE_CORR_CLIPS = 20, 16
BEHAVE_REFINE_CLIPS, BEHAVE_CANON_CLIPS = 8, 16
# the long-term eval at its CLI's defaults
LONG_CLIPS, LONG_ROLLOUTS, LONG_CHECK_RESPACING = 8, 4, "100"
LONG_HORIZON = 10 + (1 + LONG_ROLLOUTS) * FUTURE
# card against CPU: load-time FK and normals, the small dataset-mode eval
LOAD_TOL = 1e-5
LOAD_TOL_REASON = ("summation order of the card's FK and normals against "
                   "the CPU's, full f32 (no TF32)")
# the normals of the card's load against the CPU's: a normal is the
# normalized sum of its faces' cross products, and on the 128-vertex
# stand-in body the smallest sums turn vertices 1e-6 apart into normals
# 1.3e-5 apart (measured on the CPU by perturbing the vertices)
NORMALS_TOL = 1e-4
NORMALS_TOL_REASON = ("vertices within LOAD_TOL, amplified about 13x by "
                      "the normalization of the smallest sums of face "
                      "normals; the normals of the card's vertices are held "
                      "to the CPU's of the same vertices within LOAD_TOL")
PLAIN_TRAJECTORY_TOL = 1e-5
PLAIN_TRAJECTORY_TOL_REASON = (
    "every kernel is bitwise equal to its plain version (phase kernels), so "
    "the trajectories should be equal; only a run-to-run difference of the "
    "library calls around the kernels could move them")


def _timed_iter(batches, seconds: list):
    """``batches`` with the host seconds of each ``next`` appended to
    ``seconds`` (reading the clips: windows, canonicalization, collate)."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        seconds.append(time.perf_counter() - t0)
        yield batch


def _behave_loads(motion_path: str, models: dict, mode: str) -> tuple:
    """(sequences, their normals caches removed first, so that the forward
    runs) of one split."""
    from interdiff_torch.data.behave import load_behave_sequences, split_names

    for name in split_names(motion_path, mode):
        cache = os.path.join(motion_path, name, "human_normal.npz")
        if os.path.exists(cache):
            os.remove(cache)
    timings = {}
    seqs = load_behave_sequences(motion_path, smpl_models=models, mode=mode,
                                 timings=timings)
    return seqs, timings


def phase_behave_cpu_vs_gpu(gpu: str) -> None:
    """The data path on the card against the CPU on a small corpus
    (`write_behave_corpus`: one train and one test sequence of 120 frames,
    512 points) and the 128-vertex stand-in body read back from its pkl:
    the load-time vertices within LOAD_TOL, the normals within NORMALS_TOL
    and within LOAD_TOL of the CPU's normals of the card's vertices, each
    device with its own normals cache; the clips' start frames and the
    arrays that do not go through FK (poses, object angles) identical, the
    translations (the FK pelvis is their centroid) within LOAD_TOL; then
    `evaluate` of
    2 light clips of the test split, with correction, at "5" respacing,
    the same batch and noise on both: every metric within 1e-4."""
    import tempfile

    from interdiff_torch.cli.common import synthetic_smpl_body
    from interdiff_torch.cli.eval_smpl_short import evaluate
    from interdiff_torch.config import (
        CorrectionConfig,
        DiffusionConfig,
        SmplTrackConfig,
    )
    from interdiff_torch.data.behave import BehaveDataset, collate
    from interdiff_torch.eval.smpl_short import SmplEvalConfig
    from interdiff_torch.geometry.normals import vertex_normals
    from interdiff_torch.smpl.loader import smpl_model_from_pkl

    rng = np.random.default_rng(SEED + 60)
    body = synthetic_smpl_body(np.random.default_rng(SEED + 61),
                               device="cpu")
    state = seeded_state(SmplTrackConfig(**SMALL).build_model("cpu"),
                         SEED + 62)
    projector_state = seeded_state(
        CorrectionConfig(num_nodes=40, dct=4).build_model("cpu"), SEED + 63)
    noises = [(torch.from_numpy(rng.standard_normal(
        (4, FRAMES, 144)).astype(np.float32)), torch.from_numpy(
            rng.standard_normal((5, 4, FRAMES, 144)).astype(np.float32)))]
    line = {"phase": "behave_cpu_vs_gpu", "gpu": gpu, "frames": 120,
            "points": 512, "verts": body.num_verts,
            "load_tolerance": LOAD_TOL, "load_tolerance_reason":
            LOAD_TOL_REASON}
    with tempfile.TemporaryDirectory() as root:
        motion_path, model_path = write_behave_corpus(
            root, body, rng, sequences=1, frames=120, points=512)
        loaded, clips, metrics = {}, {}, {}
        for dev in ("cpu", DEV):
            bodies = {g: smpl_model_from_pkl(
                os.path.join(model_path, f"SMPLH_{g}.pkl"), device=dev)
                for g in ("male", "female")}
            seqs = {m: _behave_loads(motion_path, bodies, m)[0]
                    for m in ("train", "test")}
            loaded[dev] = seqs
            ds = BehaveDataset(seqs["test"], rng=np.random.default_rng(5),
                               fields="light")
            clips[dev] = collate([ds[i] for i in range(len(ds))])
            track = SmplTrackConfig(**SMALL, diffusion=DiffusionConfig(
                timestep_respacing="5"))
            model = track.build_model(dev)
            model.load_state_dict(state, strict=True)
            projector = CorrectionConfig(num_nodes=40,
                                         dct=4).build_model(dev)
            projector.load_state_dict(projector_state, strict=True)
            batch = {k: v[:2] for k, v in clips["cpu"].items()}
            totals, _ = evaluate(
                SmplEvalConfig(correction_t_max=4, correction_every=2),
                model, track.diffusion.build(dev), bodies["male"], [batch],
                projector=projector, diverse_samples=2, diverse_fold=2,
                markers_idx=SMALL_MARKERS,
                noises=iter([tuple(t.to(dev) for t in pair)
                             for pair in noises]),
                report=lambda nb, means: None)
            metrics[dev] = totals
    load_err = {}
    for mode in ("train", "test"):
        for a, b in zip(loaded["cpu"][mode], loaded[DEV][mode]):
            verts = torch.from_numpy(b.human_verts[..., :3].copy())
            parts = {"verts": (a.human_verts[..., :3], b.human_verts[..., :3]),
                     "normals": (a.human_verts[..., 3:], b.human_verts[..., 3:]),
                     # the card's normals against the CPU's of the card's
                     # vertices: the normals' own arithmetic
                     "normals_of_card_verts": (vertex_normals(
                         verts, body.faces_idx, body.incident).numpy(),
                         b.human_verts[..., 3:])}
            parts.update({k: (a.__dict__[k], b.__dict__[k]) for k in (
                "pelvis", "left_foot", "right_foot")})
            for key, (x, y) in parts.items():
                err = float(np.abs(x - y).max())
                load_err[key] = max(load_err.get(key, 0.0), err)
    exact = ("body_pose", "obj_angles", "start_frame", "gender",
             "obj_points", "ground_joint_label")
    clip_equal = {k: bool(np.array_equal(clips["cpu"][k], clips[DEV][k]))
                  for k in exact}
    clip_err = {k: float(np.abs(clips["cpu"][k] - clips[DEV][k]).max())
                for k in ("body_trans", "pelvis", "obj_trans")}
    metric_err = {k: abs(metrics["cpu"][k] - metrics[DEV][k])
                  for k in metrics["cpu"]}
    line.update(load_max_abs_err=load_err, normals_tolerance=NORMALS_TOL,
                normals_tolerance_reason=NORMALS_TOL_REASON,
                clips=len(clips["cpu"]["start_frame"]),
                start_frames=clips[DEV]["start_frame"].tolist(),
        clip_arrays_identical=clip_equal, clip_max_abs_err=clip_err,
        evaluate_metrics_cuda=metrics[DEV], evaluate_max_abs_err=metric_err,
        evaluate_tolerance=1e-4, evaluate_tolerance_reason=(
            CORRECTED_TOL_REASON + "; one penetrating point that flips "
            "between devices moves penetrate by 3.9e-5 here"))
    emit(line)
    if not (load_err.pop("normals") <= NORMALS_TOL
            and max(load_err.values()) <= LOAD_TOL
            and all(clip_equal.values())
            and max(clip_err.values()) <= LOAD_TOL
            and max(metric_err.values()) <= 1e-4):
        raise AssertionError(f"behave_cpu_vs_gpu: {line}")


def _behave_corpus(root: str, body) -> tuple:
    """The full-size corpus of the BEHAVE phases under ``root`` and the
    bodies read back from its pkls on the card: (motion_path, model_path,
    bodies, seconds to write)."""
    from argparse import Namespace

    from interdiff_torch.cli.common import load_smpl_models

    t0 = time.perf_counter()
    motion_path, model_path = write_behave_corpus(
        root, body, np.random.default_rng(SEED + 64),
        sequences=BEHAVE_SEQUENCES, frames=BEHAVE_FRAMES, points=POINTS)
    written = time.perf_counter() - t0
    bodies = load_smpl_models(Namespace(model_path=model_path,
                                        synthetic_body=False), DEV)
    return motion_path, model_path, bodies, written


def phase_behave(group, nn, sa, models, gpu: str) -> dict:
    """The dataset routes of the four SMPL entry points at full width on a
    written corpus (`write_behave_corpus`: BEHAVE_SEQUENCES train and test
    sequences of BEHAVE_FRAMES frames, 2048 points; the V=6890 stand-in
    body read back from its SMPL-H pkl): the load (seconds per sequence of
    FK + normals on the card, and of reading the files), canonicalization
    seconds per clip with light and with full fields; the eval entry
    point's `evaluate` on one batch of 32 test clips, 4 diverse samples,
    correction, "100" respacing; `train(...)` of the diffusion trainer for
    BEHAVE_TRAIN_STEPS steps on the train split with a validation on the
    first test batch at "25"; `train(...)` of the correction trainer, 16
    clips with every field, BEHAVE_TRAIN_STEPS steps (half in the
    initialize phase), the host's data seconds apart; the refiner's
    dataset route on 8 test clips, 200 iterations.  Each path's launches
    are asserted.  Returns the launches by path."""
    import tempfile

    from interdiff_torch.cli.common import batch_iterator
    from interdiff_torch.cli.eval_smpl_short import evaluate
    from interdiff_torch.cli.optimization import refine_dataset
    from interdiff_torch.cli.train_correction_smpl import (
        train as train_correction,
    )
    from interdiff_torch.cli.train_diffusion_smpl import train
    from interdiff_torch.config import DiffusionConfig
    from interdiff_torch.data.behave import BehaveDataset, collate
    from interdiff_torch.eval.optimization import OptimConfig
    from interdiff_torch.eval.smpl_short import SmplEvalConfig

    mdm, projector, body = models
    by_path = {}
    with tempfile.TemporaryDirectory() as root:
        motion_path, _, bodies, write_s = _behave_corpus(root, body)
        train_seqs, train_t = _behave_loads(motion_path, bodies, "train")
        test_seqs, test_t = _behave_loads(motion_path, bodies, "test")
        n_seq = train_t["sequences"] + test_t["sequences"]
        load = {"sequences": n_seq, "frames": BEHAVE_FRAMES,
                "write_corpus_s": write_s,
                "forward_s_per_sequence": (train_t["forward"]
                                           + test_t["forward"]) / n_seq,
                "read_s_per_sequence": (train_t["read"] + test_t["read"])
                / n_seq}
        canon = {}
        for fields in ("light", "full"):
            ds = BehaveDataset(train_seqs, rng=np.random.default_rng(SEED),
                               fields=fields)
            t0 = time.perf_counter()
            for i in range(BEHAVE_CANON_CLIPS):
                ds[i]
            canon[fields] = (time.perf_counter() - t0) / BEHAVE_CANON_CLIPS
        load["canonicalize_s_per_clip"] = canon
        emit({"phase": "behave", "part": "load", "gpu": gpu, **load})

        # the eval entry point, one batch of 32 test clips
        rng = np.random.default_rng(SEED + 65)
        test_light = BehaveDataset(test_seqs, rng=rng, fields="light")
        batch = next(iter(batch_iterator(test_light, collate,
                                         batch_size=CLIPS, rng=rng,
                                         shuffle=False)))
        diffusion = DiffusionConfig(
            timestep_respacing=BEHAVE_EVAL_RESPACING).build(DEV)
        timings = {}
        torch.cuda.synchronize()
        _reset_launches(group, nn, sa)
        t0 = time.perf_counter()
        totals, nb = evaluate(
            SmplEvalConfig(), mdm, diffusion, bodies["male"], [batch],
            projector=projector, diverse_samples=BEHAVE_DIVERSE,
            diverse_fold=FOLD,
            generator=torch.Generator(device=DEV).manual_seed(SEED),
            report=lambda n, means: None, timings=timings)
        wall = time.perf_counter() - t0
        launched = _read_launches(group, nn, sa)
        calls = BEHAVE_DIVERSE // FOLD
        # "100" respacing: the gate fires at the respaced t = 50 and 0
        want = {**NO_LAUNCHES, "K1": 2, "K2": 2 * calls, "K4": 2 * calls,
                "K3": calls}
        by_path["behave_eval"] = launched
        line = {"phase": "behave", "part": "eval", "gpu": gpu,
                "clips": CLIPS, "diverse_samples": BEHAVE_DIVERSE,
                "respacing": BEHAVE_EVAL_RESPACING, "metrics": totals,
                "batches": nb, "wall_s": wall, "part_s": timings,
                "sequences_per_s": CLIPS * BEHAVE_DIVERSE / wall,
                "launches": launched}
        emit(line)
        if launched != want or not all(np.isfinite(v)
                                       for v in totals.values()):
            raise AssertionError(f"behave eval: {line}")

        # the diffusion trainer on the train split
        train_light = BehaveDataset(train_seqs, rng=rng, fields="light")
        val_batch = next(iter(batch_iterator(test_light, collate,
                                             batch_size=CLIPS, rng=rng,
                                             shuffle=False)))
        per_epoch = len(train_light) // CLIPS
        data_s = []
        model = _train_model()
        with tempfile.TemporaryDirectory() as results:
            rec = _timed_train(lambda on_step: train(
                model, DiffusionConfig().build(DEV),
                lambda: _timed_iter(batch_iterator(
                    train_light, collate, batch_size=CLIPS, rng=rng),
                    data_s),
                results_dir=results,
                epochs=BEHAVE_TRAIN_STEPS // per_epoch,
                val_every=BEHAVE_TRAIN_STEPS // per_epoch,
                val_diffusion=DiffusionConfig(
                    timestep_respacing="25").build(DEV),
                val_batch=val_batch,
                generator=torch.Generator(device=DEV).manual_seed(SEED),
                on_step=on_step), group, nn, sa)
        steps = rec["summary"]["steps"]
        want = {**NO_LAUNCHES, "K1": 2 * steps + 2}  # + the validation
        by_path["behave_train"] = rec["launches"]
        line = {"phase": "behave", "part": "train", "gpu": gpu,
                "clips": CLIPS, "steps": steps,
                "ms_per_step_median": statistics.median(rec["step_ms"][1:]),
                "data_s_per_step": sum(data_s) / len(data_s),
                "losses_first_last": [rec["losses"][0], rec["losses"][-1]],
                "val_loss": rec["summary"]["val_loss"],
                "wall_s": rec["wall_s"], "launches": rec["launches"],
                "peak_mem_gb": rec["peak_mem_gb"]}
        emit(line)
        if steps != BEHAVE_TRAIN_STEPS or rec["launches"] != want or \
                not np.isfinite(rec["losses"]).all():
            raise AssertionError(f"behave train: {line}")

        # the correction trainer, every field of a clip
        train_full = BehaveDataset(train_seqs, rng=rng)
        per_epoch = len(train_full) // BEHAVE_CORR_CLIPS
        data_s = []
        corr = _correction_projectors(DEV, small=False)[0]
        with tempfile.TemporaryDirectory() as results:
            rec = _timed_train(lambda on_step: train_correction(
                corr, lambda: _timed_iter(batch_iterator(
                    train_full, collate, batch_size=BEHAVE_CORR_CLIPS,
                    rng=rng), data_s),
                results_dir=results,
                epochs=BEHAVE_TRAIN_STEPS // per_epoch,
                initialize_epochs=BEHAVE_TRAIN_STEPS // per_epoch // 2,
                generator=torch.Generator(device=DEV).manual_seed(SEED),
                on_step=on_step), group, nn, sa)
        steps = rec["summary"]["steps"]
        want = {**NO_LAUNCHES, "K3": steps, "K4": steps}
        by_path["behave_correction_train"] = rec["launches"]
        step_ms = statistics.median(rec["step_ms"][1:])
        line = {"phase": "behave", "part": "correction_train", "gpu": gpu,
                "clips": BEHAVE_CORR_CLIPS, "steps": steps,
                "ms_per_step_median": step_ms,
                "data_s_per_step": sum(data_s) / len(data_s),
                "device_and_dispatch_ms_per_step":
                    step_ms - 1e3 * statistics.median(data_s),
                "losses_first_last": [rec["losses"][0], rec["losses"][-1]],
                "wall_s": rec["wall_s"], "launches": rec["launches"],
                "peak_mem_gb": rec["peak_mem_gb"]}
        emit(line)
        if steps != BEHAVE_TRAIN_STEPS or rec["launches"] != want or \
                not np.isfinite(rec["losses"]).all():
            raise AssertionError(f"behave correction_train: {line}")

        # the refiner's dataset route, 8 ground-truth test clips
        refine_ds = BehaveDataset(test_seqs, past_len=REFINE_PAST,
                                  future_len=REFINE_FUTURE, fields="light")
        timings = {}
        torch.cuda.synchronize()
        _reset_launches(group, nn, sa)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as out_dir:
            summary = refine_dataset(
                bodies, refine_ds, OptimConfig(
                    iters=REFINE_ITERS, keep_after=min(150,
                                                       REFINE_ITERS - 2)),
                past_len=REFINE_PAST, out_dir=out_dir,
                batch_size=BEHAVE_REFINE_CLIPS, limit=BEHAVE_REFINE_CLIPS,
                timings=timings)
            written = len(os.listdir(out_dir))
        wall = time.perf_counter() - t0
        launched = _read_launches(group, nn, sa)
        want = {**NO_LAUNCHES, "K2": 2, "K3": REFINE_ITERS,
                "K4": REFINE_ITERS}
        by_path["behave_refine"] = launched
        line = {"phase": "behave", "part": "refine", "gpu": gpu,
                "clips": BEHAVE_REFINE_CLIPS, "iters": REFINE_ITERS,
                "summary": summary, "wall_s": wall, "part_s": timings,
                "ms_per_refine_iteration": timings["refine"] * 1e3
                / REFINE_ITERS, "launches": launched}
        emit(line)
        if launched != want or written != BEHAVE_REFINE_CLIPS + 1 or \
                not all(np.isfinite(summary[k]) for k in (
                    "penetrate_before", "penetrate_after", "depth_before",
                    "depth_after")):
            raise AssertionError(f"behave refine: {line}")
    return by_path


@contextlib.contextmanager
def _plain_kernels(group, nn, frames: int = 16):
    """Every kernel wrapper of the sampler's path (K1, K2, K3, K4) runs its
    plain version on the card inside the block, ``frames`` frames at a time
    for the sweeps (a whole [280, 2048, 6890] score tensor is 16 GB)."""
    saved = (group.group_cuda, nn.signed_nearest_pruned_cuda,
             nn.signed_nearest_cuda, nn.nearest_neighbor_cuda)

    def chunked(plain):
        def run(a, *rest):
            parts = [plain(a[s:s + frames], *(r[s:s + frames]
                                              if torch.is_tensor(r) else r
                                              for r in rest))
                     for s in range(0, a.shape[0], frames)]
            return tuple(torch.cat(p) for p in zip(*parts))
        return run

    group.group_cuda = group.group_plain
    nn.signed_nearest_pruned_cuda = chunked(nn.signed_nearest_pruned_plain)
    nn.signed_nearest_cuda = chunked(nn.signed_nearest_plain)
    nn.nearest_neighbor_cuda = chunked(nn.nearest_neighbor_plain)
    try:
        yield
    finally:
        (group.group_cuda, nn.signed_nearest_pruned_cuda,
         nn.signed_nearest_cuda, nn.nearest_neighbor_cuda) = saved


def phase_long_eval(group, nn, sa, models, gpu: str) -> dict:
    """The long-term eval entry point at its CLI's defaults (8 test clips,
    4 rollouts, 1000 DDPM steps, ``--mode correction``) on a written
    corpus read through ``--model_path``: `cli/eval_smpl_long.py::setup`
    from the parsed flags, with the serving weights of `full_width_models`
    in place of the seeded ones, then `evaluate_long` on its first batch:
    seconds per chunk, sequences per second, launches (per batch 5 encodes'
    K1, 55 K2, 55 K4, 0 K3), the rollout [8, 135, 144] finite, the drift of
    each window.  Then the same batch at "100" respacing twice from one
    seed, through the kernels and through their plain versions
    (`_plain_kernels`): the trajectories within PLAIN_TRAJECTORY_TOL.
    Returns the launches of the main run."""
    import tempfile

    from interdiff_torch.cli.eval_smpl_long import (
        build_parser,
        evaluate_long,
        setup,
    )
    from interdiff_torch.config import DiffusionConfig

    mdm, projector, body = models
    with tempfile.TemporaryDirectory() as root:
        motion_path, model_path, _, _ = _behave_corpus(root, body)
        out_dir = os.path.join(root, "out")
        args = build_parser().parse_args([
            "--motion_path", motion_path, "--model_path", model_path,
            "--mode", "correction", "--out_dir", out_dir])
        t0 = time.perf_counter()
        parts = setup(args, DEV)
        setup_s = time.perf_counter() - t0
        parts.update(model=mdm, projector=projector)
        batch = next(iter(parts.pop("batches")))
        timings, outputs = {}, []
        torch.cuda.synchronize()
        _reset_launches(group, nn, sa)
        summary = evaluate_long(**parts, batches=[batch], max_batches=1,
                                timings=timings, outputs=outputs)
        launched = _read_launches(group, nn, sa)
        calls = 1 + LONG_ROLLOUTS
        firings = 11 * calls
        want = {**NO_LAUNCHES, "K1": 2 * calls, "K2": firings,
                "K4": firings}
        full = outputs[0]
        written = sorted(os.listdir(out_dir))
        steps = parts["diffusion"].num_timesteps
        line = {"phase": "long_eval", "gpu": gpu, "clips": LONG_CLIPS,
                "rollouts": LONG_ROLLOUTS, "steps": steps,
                "horizon": LONG_HORIZON, "setup_s": setup_s,
                "part_s": timings,
                "s_per_chunk": timings["rollout"] / timings["chunks"],
                "ms_per_ddpm_step": timings["rollout"] * 1e3
                / (timings["chunks"] * steps),
                "sequences_per_s": LONG_CLIPS / timings["rollout"],
                "launches": launched, "launches_want": want,
                "rollout_shape": list(full.shape),
                "rollout_finite": bool(torch.isfinite(full).all()),
                "drift_per_window": summary, "written": written}
        emit(line)
        if launched != want or tuple(full.shape) != (
                LONG_CLIPS, LONG_HORIZON, 144) or not line[
                "rollout_finite"] or written != [
                "drift_metrics.json", "rollout_0.npy"] or len(summary) != \
                calls or not all(np.isfinite(v) for w in summary
                                 for v in w.values()):
            raise AssertionError(f"long_eval: {line}")

        # kernels against their plain versions on the whole path
        parts["diffusion"] = DiffusionConfig(
            timestep_respacing=LONG_CHECK_RESPACING).build(DEV)
        runs = {}
        for route in ("kernels", "plain"):
            outs = []
            parts["generator"] = torch.Generator(device=DEV).manual_seed(
                SEED)
            before = _read_launches(group, nn, sa)
            with (_plain_kernels(group, nn) if route == "plain"
                  else contextlib.nullcontext()):
                evaluate_long(**{**parts, "out_dir": out_dir + route},
                              batches=[batch], max_batches=1, outputs=outs)
            after = _read_launches(group, nn, sa)
            runs[route] = (outs[0], {k: after[k] - before[k]
                                     for k in after})
        err = float((runs["kernels"][0] - runs["plain"][0]).abs().max())
        line = {"phase": "long_eval", "part": "kernels_vs_plain", "gpu": gpu,
                "respacing": LONG_CHECK_RESPACING,
                "launches_kernels": runs["kernels"][1],
                "launches_plain": runs["plain"][1],
                "trajectory_max_abs_diff": err,
                "tolerance": PLAIN_TRAJECTORY_TOL,
                "tolerance_reason": PLAIN_TRAJECTORY_TOL_REASON}
        emit(line)
        if any(runs["plain"][1].values()) or not err <= \
                PLAIN_TRAJECTORY_TOL or runs["kernels"][1]["K2"] != 2 * calls:
            raise AssertionError(f"long_eval kernels_vs_plain: {line}")
    return launched


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
    phase_skeleton_cpu_vs_gpu(group, nn, sa, gpu)
    phase_sampler(group, nn, sa, models, gpu)
    eval_launches = phase_eval(group, nn, sa, models, gpu)
    train_launches = phase_train(group, nn, sa, gather, gpu)
    phase_profile(models, gpu)
    phase_profile_train(gpu)
    skeleton_launches = phase_skeleton(group, nn, sa, gpu)
    phase_correction_cpu_vs_gpu(gpu)
    correction_launches, at_train = phase_correction_train(
        group, nn, sa, models[2], gpu)
    refine_launches, at_refine = phase_refine(group, nn, sa, models[2], gpu)
    phase_behave_cpu_vs_gpu(gpu)
    behave_launches = phase_behave(group, nn, sa, models, gpu)
    long_launches = phase_long_eval(group, nn, sa, models, gpu)
    # every kernel must have run on a main path: the eval entry point's
    # (K1-K4; K6 on its opt-in route) or the training entry point's (K1; K6
    # on its opt-in route; K5 in the backward with respect to the cloud);
    # the skeleton track's entry points launch none of them, the correction
    # trainer of the SMPL track K3 and K4, the refiner K1-K4
    by_path = {"eval": eval_launches,
               "train": {"K2": 0, "K3": 0, "K4": 0, **train_launches},
               **skeleton_launches, **correction_launches,
               "refine": refine_launches, **behave_launches,
               "long_eval": long_launches}
    launches = {k: sum(n[k] for n in by_path.values())
                for k in by_path["eval"]}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never ran on a main path: {by_path}")
    no_kernel = list(skeleton_launches) + ["correction_train_skeleton"]
    if any(by_path[p] != NO_LAUNCHES for p in no_kernel):
        raise AssertionError(f"a kernel ran on a skeleton path: {by_path}")
    for key in ("K3", "K4"):
        timed[key]["at_slice_shapes"] = {"correction_train": at_train[key],
                                         "refine": at_refine[key]}

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
        **{k: timed[key][k] for k in (
            "frames", "plain_frames", "unfused_ms",
            "with_grouped_ms",
            "ptxas", "graph_replay_ms", "device_ms_by_kernel",
            "segment_flags_device_ms", "device_ms", "ms_back_to_back",
            "library_device_ms", "library_ms_back_to_back",
            "at_slice_shapes")
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
