// Brute-force nearest-neighbour sweeps on Hopper (sm_90a): kernels K2, K3, K4.
//
// Replaces three Pallas entries of interdiff_tpu/ops/pallas_nn.py:
//   K4  nn_nearest_f32        <- nearest_neighbor_pallas      (_nn_kernel)
//   K3  nn_signed_f32         <- signed_nearest_pallas        (_signed_nn_kernel), forward
//   K2  nn_signed_pruned_f32  <- signed_nearest_pruned_pallas (_make_seg_signed_kernel_fori)
//
// For every query a of frame f the sweep finds j* = argmin_j |a - b_j|^2 over
// the frame's M surface points and returns sq = |a - b_j*|^2 and j*; the
// signed sweeps also return sdot = n_j* . (a - b_j*), whose sign says on which
// side of the surface the query lies.
//
// Arithmetic (bit-identical to the plain PyTorch versions in ops/nn.py):
//   b2_j    = (bx*bx + by*by) + bz*bz
//   score_j = b2_j - 2*((ax*bx + ay*by) + az*bz)
//   j*      = first j with the least score (candidates walked in increasing
//             index, replaced on strict <)
//   sq      = max(score_j* + ((ax*ax + ay*ay) + az*az), 0)
//   sdot    = ((ax*nx + ay*ny) + az*nz) - ((nx*bx + ny*by) + nz*bz)   at j*
// with every product and sum rounded to float32 on its own (__fmul_rn,
// __fadd_rn: the compiler may not contract them).  2*dot is exact in binary
// floating point, so the single fused step fma(-2, dot, b2) rounds once, to
// the same float as b2 - 2*dot.
//
// K4, nearest_kernel<T, G, QC>: T = 128 threads a block, a block a
// frame, the frame's surface split over the threads: thread t holds G = 16
// consecutive points (x, y, z, |b|^2) in registers, t*G .. t*G+G-1 of a
// pass of T*G = 2048 points (one pass at the main-path M = 2048; a ragged
// last pass is padded with points of score +inf).  At the main-path shape
// a frame has only N = 67 queries, which left two thirds of a
// one-query-a-thread block idle; here every lane works at any N.
// 0. A pass's points are copied coalesced and asynchronously (cp.async)
//    into shared memory, for each thread to take its G points; the next
//    pass's copy runs while this one is computed.  (Persistent blocks,
//    each walking frames and copying the next frame's points early, were
//    slower on an H100 than this plain grid.)
// 1. The queries come in chunks of QC = 32, staged in shared memory.  Per
//    query (a broadcast 16-byte shared load), each thread computes the G
//    scores of its points and their minimum (a tree of fminf) and stores it
//    to part[query][t]: about 7.75 instructions a pair (6 for the score,
//    15/16 of a minimum, 2/16 of a shared load and store, the loop).
// 2. Four threads a query: each scans a quarter of the T minima for the
//    least and its first thread (strict <), and the four merge by (value,
//    thread), giving the first thread t holding the least value v.  Then
//    the four score thread t's G points again by the same arithmetic and
//    the least g whose score is v is the first occurrence in the pass.
//    Threads and points are in index order; passes merge in increasing
//    order with a strict <, the running (score, j) kept in the outputs
//    between passes, so j* is the first occurrence of the least score
//    overall, the plain version's argmin.
//    (A merge of one warp a query, each rescanning from global memory in
//    the warp's serial loop, was latency-bound: 0.24-0.30 ms at the
//    main-path shape on an H100.)
// Bound: operations, 8 a pair; the bitwise contract leaves 6 of them fixed.
// scripts/torch_kernel_probes.py rebuilds the library with -DK4_THREADS,
// -DK4_POINTS, -DK4_QCHUNK and -DK4_MIN_BLOCKS to time other settings.
//
// K2, the pruned sweep, in three kernels launched by one entry:
//
// 1. segment_list_kernel, one block per frame: the bounding box of the
//    frame's queries; for every segment of TILE surface points the least
//    boxd2 = (ex*ex + ey*ey) + ez*ez (rounded step by step; e the distance
//    of the point outside the box along each axis); flags[f, s] = boxd2 <
//    delta^2 * 1.01 rounded to float32 (the slack of ops/nn.py::
//    segment_flags, which computes the same flags in plain PyTorch); and the
//    flagged ids compacted in increasing order, count[f] of them, -1 after.
//    A query whose nearest point is closer than delta finds it in a flagged
//    segment, so the result is bit-equal to the full sweep there; every query
//    with sq >= delta^2, those with no flagged segment included (the running
//    minimum starts at 3.0e38), gets exactly (delta^2, +1, 0).  The count
//    stays on the device: nothing here waits for the host.
// 2. frame_order_kernel, one block: the frames by decreasing count (a
//    counting sort), so that the sweep dispatches its longest blocks first
//    and its last wave holds short ones.  A frame's blocks take from 0 to
//    27 tiles at the main-path shape: dispatched in frame order, a long
//    block late in the grid kept the card waiting at the end.
// 3. signed_sweep_kernel<T, Q, G, false>, one block per (frame, T*Q
//    queries): it walks the frame's flagged segments only, one tile each.
//    One setting is built: T = 256 threads, Q = 8 queries a thread, groups
//    of G = 8, one block a frame at N = 2048, the fastest of three on an
//    H100 (PERF.md; scripts/torch_kernel_probes.py rebuilds the library
//    with -DK2_THREADS, -DK2_QUERIES and -DK2_GROUP to time others).
//    - Register blocking: thread t owns queries t, t+T, ..., t+(Q-1)T (loads
//      and stores stay coalesced), so one broadcast shared load of a point
//      feeds Q pairs.
//    - Double buffering: while the block computes tile i, each thread holds
//      its share of tile i+1 in registers (loads issued before the compute),
//      stores it to the other buffer after, and one __syncthreads a tile
//      separates the two.
//    - Grouped first-occurrence selection: per query the G scores of G
//      consecutive points, their minimum m by fminf (a tree over the G
//      scores; the G points sit in registers for the Q queries), and one
//      comparison
//      m < best that keeps (best, g*) = (m, the group's first point) when it
//      holds, by selects and no branch.  After the last tile the G scores of
//      group g* are computed again, by the same arithmetic from the same
//      points in global memory, and j* is the first j of it whose score
//      equals best.  This equals the sequential walk with strict <: that
//      walk ends at the first occurrence of the least score; the groups
//      before g* hold no score as small (else one of them would have won
//      the strict comparison), and inside g* the first j with s_j == best
//      is that occurrence.  best is the group minimum's value, the value of
//      a score; fminf returns one of its inputs, and a score of -0.0 cannot
//      occur (b2 >= +0), so best has that score's bits.  fminf skips a NaN
//      score and == never matches one, so a NaN is never selected, as in the
//      walk.  (A first version rescanned the group inside the loop, on a
//      branch, whenever m < best: 3.7-4.0 ms at the main-path data on an
//      H100, the branch diverging across the warp's queries.)
//    A ragged last tile is padded with points of score +inf, which neither
//    the minimum nor the comparison with best (at most 3.0e38) can take.
//    Per pair: six rounded float32 operations for the score, (G-1)/G of a
//    minimum, 3/G of a comparison and two selects, and 1/Q of a shared load:
//    about 7.4 instructions at G = 8, Q = 8, against the 9-10 of a loop of
//    one query a thread that replaces best on a branch.
//    Bound: operations (8 a pair over the flagged pairs of this call's data).
//
// K3, the full sweep, is the same kernel with FULL = true:
// signed_sweep_kernel<T, Q, G, true> walks every segment in index order,
// with no prologue, no frame order, no reads of count, ids or order and no
// forcing beyond delta, so K2 equals K3 inside delta by construction.  A
// query whose best never drops below SCORE_INF keeps j = 0, as the walk
// does.  Bound: operations, 8 a pair over all F * N * M pairs (2.26e10 at
// 1600 frames, N=2048, M=6890: 2.70 ms at 67 TFLOP/s).  The shape is chosen
// for whole waves, every block doing the same work: at K2's 256/8/8 (101
// registers, 2 blocks an SM) the 1600 blocks fill 6.06 waves of 264 and
// the seventh runs 6 % full; K3 is built at T = 128, Q = 8, G = 8 (1024
// queries a block, two blocks a frame at N = 2048; the registers ptxas
// reports set the blocks an SM: at most 96 give 5, so 3200 blocks fill
// 4.85 waves of 660), the fastest of four settings on an H100 (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;     // surface points per shared-memory tile = pruning segment
constexpr float SCORE_INF = 3.0e38f;  // beats no real score

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}


// ---- K2 ---------------------------------------------------------------------

constexpr int LIST_THREADS = 256;  // threads of the prologue's block

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__global__ void __launch_bounds__(LIST_THREADS)
    segment_list_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, int* __restrict__ flags,
                        int* __restrict__ count, int* __restrict__ ids, int N,
                        int M, int n_seg, float flag_thr) {
  constexpr int WARPS = LIST_THREADS / 32;
  __shared__ float part[6][WARPS];
  __shared__ float box[6];  // lo x, y, z, hi x, y, z
  const int frame = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the bounding box of the frame's queries
  const float* af = a + (size_t)frame * N * 3;
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = inf_f();
    hi[c] = -inf_f();
  }
  for (int q = threadIdx.x; q < N; q += LIST_THREADS) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = af[(size_t)q * 3 + c];
      lo[c] = fminf(lo[c], v);
      hi[c] = fmaxf(hi[c], v);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    lo[c] = warp_min(lo[c]);
    hi[c] = warp_max(hi[c]);
    if (lane == 0) {
      part[c][warp] = lo[c];
      part[3 + c][warp] = hi[c];
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float v = part[threadIdx.x][0];
    for (int w = 1; w < WARPS; ++w) {
      v = threadIdx.x < 3 ? fminf(v, part[threadIdx.x][w])
                          : fmaxf(v, part[threadIdx.x][w]);
    }
    box[threadIdx.x] = v;
  }
  __syncthreads();

  // one warp a segment: the least box distance of its points
  const float* bf = b + (size_t)frame * M * 3;
  int* ff = flags + (size_t)frame * n_seg;
  for (int s = warp; s < n_seg; s += WARPS) {
    float m = inf_f();
    const int end = min(M, (s + 1) * TILE);
    for (int k = s * TILE + lane; k < end; k += 32) {
      const float* p = bf + (size_t)k * 3;
      const float ex = fmaxf(fmaxf(box[0] - p[0], p[0] - box[3]), 0.0f);
      const float ey = fmaxf(fmaxf(box[1] - p[1], p[1] - box[4]), 0.0f);
      const float ez = fmaxf(fmaxf(box[2] - p[2], p[2] - box[5]), 0.0f);
      m = fminf(m, dot3(ex, ey, ez, ex, ey, ez));
    }
    m = warp_min(m);
    if (lane == 0) ff[s] = m < flag_thr;
  }
  __syncthreads();  // the frame's flags are visible to the whole block

  // compaction by one warp, 32 flags a ballot
  if (warp == 0) {
    int* fid = ids + (size_t)frame * n_seg;
    int total = 0;
    for (int s0 = 0; s0 < n_seg; s0 += 32) {
      const int s = s0 + lane;
      const bool flagged = s < n_seg && ff[s] != 0;
      const unsigned mask = __ballot_sync(~0u, flagged);
      if (flagged) fid[total + __popc(mask & ((1u << lane) - 1u))] = s;
      total += __popc(mask);
    }
    for (int i = total + lane; i < n_seg; i += 32) fid[i] = -1;
    if (lane == 0) count[frame] = total;
  }
}

constexpr int ORDER_THREADS = 1024;
constexpr int ORDER_BINS = 256;  // counts from 255 up share the first bin

__device__ __forceinline__ int order_bin(int count) {
  return ORDER_BINS - 1 - min(count, ORDER_BINS - 1);
}

// One block: order[i] = the frames by decreasing count of flagged segments
// (a counting sort; frames of one count in any order).  The sweep's blocks
// are dispatched longest first, so its last wave holds short blocks.
__global__ void __launch_bounds__(ORDER_THREADS)
    frame_order_kernel(const int* __restrict__ count, int* __restrict__ order,
                       int B) {
  __shared__ int start[ORDER_BINS];
  for (int i = threadIdx.x; i < ORDER_BINS; i += ORDER_THREADS) start[i] = 0;
  __syncthreads();
  for (int f = threadIdx.x; f < B; f += ORDER_THREADS) {
    atomicAdd(&start[order_bin(count[f])], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int i = 0; i < ORDER_BINS; ++i) {
      const int c = start[i];
      start[i] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < B; f += ORDER_THREADS) {
    order[atomicAdd(&start[order_bin(count[f])], 1)] = f;
  }
}

// |b|^2 - 2 a.b for c = (bx, by, bz, |b|^2), rounded as in K3 and K4
__device__ __forceinline__ float score(float ax, float ay, float az,
                                       float4 c) {
  return __fmaf_rn(-2.0f, dot3(ax, ay, az, c.x, c.y, c.z), c.w);
}

template <int G>
__device__ __forceinline__ float group_min(const float (&s)[G]) {
  float m[G];
#pragma unroll
  for (int j = 0; j < G; ++j) m[j] = s[j];
#pragma unroll
  for (int w = G / 2; w > 0; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) m[j] = fminf(m[j], m[j + w]);
  }
  return m[0];
}

// FULL = false: K2's sweep over the flagged segments of count, ids and
// order, forced beyond delta.  FULL = true: K3's sweep over every segment
// (count, ids and order unread, delta_sq unused).
template <int T, int Q, int G, bool FULL>
__global__ void __launch_bounds__(T)
    signed_sweep_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ n,
                        const int* __restrict__ count,
                        const int* __restrict__ ids,
                        const int* __restrict__ order,
                        float* __restrict__ sq_out,
                        float* __restrict__ sdot_out,
                        int* __restrict__ idx_out, int N, int M, int n_seg,
                        int n_chunks, float delta_sq) {
  static_assert(TILE % T == 0 && TILE % G == 0 && (G & (G - 1)) == 0,
                "a tile splits into whole shares and whole groups");
  constexpr int PER = TILE / T;  // points each thread stages a tile
  __shared__ float4 tile[2][TILE];

  // the chunks of one frame are neighbours; K2's frames longest first
  const int chunk = blockIdx.x / n_chunks;
  const int frame = FULL ? chunk : order[chunk];
  const int q0 = (blockIdx.x % n_chunks) * (T * Q) + threadIdx.x;
  const float* bf = b + (size_t)frame * M * 3;
  const int* fid = FULL ? nullptr : ids + (size_t)frame * n_seg;
  const int n_flag = FULL ? n_seg : count[frame];
  auto seg_at = [&](int i) { return FULL ? i : fid[i]; };  // i-th segment

  // per query: the least score so far and the first point of the group
  // that holds it (-1: none below SCORE_INF yet)
  float ax[Q], ay[Q], az[Q], best[Q];
  int best_g[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    const int q = q0 + i * T;
    ax[i] = ay[i] = az[i] = 0.0f;
    if (q < N) {
      const float* ap = a + ((size_t)frame * N + q) * 3;
      ax[i] = ap[0];
      ay[i] = ap[1];
      az[i] = ap[2];
    }
    best[i] = SCORE_INF;
    best_g[i] = -1;
  }

  // this thread's share of a segment: points threadIdx.x + p*T
  float px[PER], py[PER], pz[PER];
  auto fetch = [&](int seg) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int k = seg * TILE + threadIdx.x + p * T;
      px[p] = py[p] = pz[p] = 0.0f;
      if (k < M) {
        const float* src = bf + (size_t)k * 3;
        px[p] = src[0];
        py[p] = src[1];
        pz[p] = src[2];
      }
    }
  };
  auto stage = [&](float4* dst, int seg) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int k = threadIdx.x + p * T;
      dst[k] = seg * TILE + k < M
                   ? make_float4(px[p], py[p], pz[p],
                                 dot3(px[p], py[p], pz[p], px[p], py[p], pz[p]))
                   : make_float4(0.0f, 0.0f, 0.0f, inf_f());
    }
  };

  if (n_flag > 0) {
    fetch(seg_at(0));
    stage(tile[0], seg_at(0));
  }
  __syncthreads();
  for (int i = 0; i < n_flag; ++i) {
    const int base = seg_at(i) * TILE;
    const int cnt = min(TILE, M - base);
    const bool more = i + 1 < n_flag;
    const int next = more ? seg_at(i + 1) : 0;
    if (more) fetch(next);  // in flight while tile i is computed
    const float4* t = tile[i & 1];
    for (int k0 = 0; k0 < cnt; k0 += G) {
      float4 c[G];
#pragma unroll
      for (int j = 0; j < G; ++j) c[j] = t[k0 + j];
#pragma unroll
      for (int qi = 0; qi < Q; ++qi) {
        float s[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          s[j] = score(ax[qi], ay[qi], az[qi], c[j]);
        }
        const float m = group_min<G>(s);
        const bool better = m < best[qi];
        best[qi] = better ? m : best[qi];
        best_g[qi] = better ? base + k0 : best_g[qi];
      }
    }
    if (more) stage(tile[(i + 1) & 1], next);
    __syncthreads();  // tile i read by all, tile i+1 stored by all
  }

#pragma unroll
  for (int qi = 0; qi < Q; ++qi) {
    const int q = q0 + qi * T;
    if (q >= N) continue;
    // the first j of the winning group whose score is best: its G scores
    // again from global memory, by the same arithmetic (past M none)
    int j = 0;
    if (best_g[qi] >= 0) {
      j = best_g[qi] + G - 1;
#pragma unroll
      for (int g = G - 1; g >= 0; --g) {
        const int k = best_g[qi] + g;
        if (k < M) {
          const float* p = bf + (size_t)k * 3;
          const float x = p[0], y = p[1], z = p[2];
          const float4 c = make_float4(x, y, z, dot3(x, y, z, x, y, z));
          if (score(ax[qi], ay[qi], az[qi], c) == best[qi]) j = k;
        }
      }
    }
    const size_t out = (size_t)frame * N + q;
    float sq = fmaxf(
        __fadd_rn(best[qi], dot3(ax[qi], ay[qi], az[qi], ax[qi], ay[qi], az[qi])),
        0.0f);
    float sdot = 1.0f;
    if (!FULL && sq >= delta_sq) {
      sq = delta_sq;
      j = 0;
    } else {
      const size_t jb = ((size_t)frame * M + j) * 3;
      const float bx = b[jb], by = b[jb + 1], bz = b[jb + 2];
      const float nx = n[jb], ny = n[jb + 1], nz = n[jb + 2];
      sdot = __fsub_rn(dot3(ax[qi], ay[qi], az[qi], nx, ny, nz),
                       dot3(nx, ny, nz, bx, by, bz));
    }
    sq_out[out] = sq;
    sdot_out[out] = sdot;
    idx_out[out] = j;
  }
}

// K2's sweep: threads a block, queries a thread, scores a group (see above)
#ifndef K2_THREADS
#define K2_THREADS 256
#endif
#ifndef K2_QUERIES
#define K2_QUERIES 8
#endif
#ifndef K2_GROUP
#define K2_GROUP 8
#endif
constexpr int SWEEP_T = K2_THREADS, SWEEP_Q = K2_QUERIES, SWEEP_G = K2_GROUP;
// K3's: 128/8/8 for whole waves (see above); scripts/torch_kernel_probes.py
// rebuilds the library with -DK3_THREADS and -DK3_QUERIES to time others
#ifndef K3_THREADS
#define K3_THREADS 128
#endif
#ifndef K3_QUERIES
#define K3_QUERIES 8
#endif
constexpr int FULL_T = K3_THREADS, FULL_Q = K3_QUERIES, FULL_G = 8;

// ---- K4 ---------------------------------------------------------------------

// K4's shape: threads a block, points a thread, queries a chunk and the
// blocks an SM its registers are held to (see above)
#ifndef K4_THREADS
#define K4_THREADS 128
#endif
#ifndef K4_POINTS
#define K4_POINTS 16
#endif
#ifndef K4_QCHUNK
#define K4_QCHUNK 32
#endif
#ifndef K4_MIN_BLOCKS
#define K4_MIN_BLOCKS 5
#endif

// the least of s[0, G) by a tree of fminf written out at compile time (a
// loop tree over 16 scores was left rolled, its array in local memory)
template <int G>
__device__ __forceinline__ float tree_min(const float* s) {
  if constexpr (G == 1) {
    return s[0];
  } else {
    return fminf(tree_min<G / 2>(s), tree_min<G / 2>(s + G / 2));
  }
}

// a 4-byte copy from global to shared memory that does not wait
__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

template <int T, int G, int QC>
__global__ void __launch_bounds__(T, K4_MIN_BLOCKS)
    nearest_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ sq_out, int* __restrict__ idx_out,
                   int N, int M) {
  constexpr int SUB = 4;            // threads a query in the merge
  static_assert(T % 32 == 0 && QC * SUB <= T && (G & (G - 1)) == 0,
                "whole warps; four threads a query; a tree of G scores");
  constexpr int SPAN = T * G;       // points a pass
  constexpr int PER = 3 * G;        // floats each thread stages a pass
  constexpr int STAGE = PER + 1;    // floats of a thread's staged points
  // a row of part: thread c of a query's four scans k = c, c + 4, ...; the
  // pitch keeps the warp's 8 queries x 4 scans on 32 banks
  constexpr int PITCH = T + 4;
  static_assert(G % SUB == 0, "four threads rescan a group");
  __shared__ float4 s_q[QC];             // the chunk's queries (x, y, z, 0)
  __shared__ float s_stage[T * STAGE];   // the pass's points
  __shared__ float s_part[QC * PITCH];   // per query, each thread's minimum

  const int frame = blockIdx.x;  // a block a frame
  const float* af = a + (size_t)frame * N * 3;
  const float* bf = b + (size_t)frame * M * 3;
  const int n_pass = (M + SPAN - 1) / SPAN;
  // 0. a pass's points, copied coalesced and asynchronously so that thread
  //    t's 3G floats start at t * STAGE (the reads below are then free of
  //    bank conflicts); past M zeros
  //    (a rolled loop: it runs while the thread holds its points, and
  //    unrolled its addresses did not fit beside them)
  auto stage = [&](int base) {
    const float* src = bf + (size_t)base * 3;
    const int end = 3 * (M - base);  // floats of the pass before M
#pragma unroll 1
    for (int e = threadIdx.x; e < PER * T; e += T) {
      float* dst = s_stage + (e / PER) * STAGE + e % PER;
      if (e < end) {
        copy_async4(dst, src + e);
      } else {
        *dst = 0.0f;
      }
    }
  };
  // Pass by pass; the next pass's points are copied while this one is
  // computed: once a thread holds its points in registers the staged copy
  // is free.
  stage(0);
  for (int pass = 0; pass < n_pass; ++pass) {
    const int base = pass * SPAN;
    const bool last = pass == n_pass - 1;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // the pass's points are staged
    float4 p[G];  // (x, y, z, |b|^2); +inf past M
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* src = s_stage + threadIdx.x * STAGE + 3 * g;
      const float x = src[0], y = src[1], z = src[2];
      p[g] = base + threadIdx.x * G + g < M
                 ? make_float4(x, y, z, dot3(x, y, z, x, y, z))
                 : make_float4(0.0f, 0.0f, 0.0f, inf_f());
    }
    __syncthreads();  // every thread holds its points
    if (!last) stage(base + SPAN);

    for (int q0 = 0; q0 < N; q0 += QC) {
      const int nq = min(QC, N - q0);
      __syncthreads();  // the points are read; the previous chunk merged
      if (threadIdx.x < nq) {
        const float* ap = af + (size_t)(q0 + threadIdx.x) * 3;
        s_q[threadIdx.x] = make_float4(ap[0], ap[1], ap[2], 0.0f);
      }
      __syncthreads();
      // 1. per query, the least score of this thread's G points
      for (int i = 0; i < nq; ++i) {
        const float4 q = s_q[i];
        float s[G];
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] = score(q.x, q.y, q.z, p[g]);
        s_part[i * PITCH + threadIdx.x] = tree_min<G>(s);
      }
      __syncthreads();
      // 2. four threads a query.  Thread c scans minima c, c + 4, ...
      //    for the least and its first thread (strict <); the four merge
      //    by (value, thread), which gives the first thread t holding the
      //    least value v.  Then thread c scores points c, c + 4, ... of
      //    thread t's G again, from global memory by the same
      //    arithmetic, and the least g whose score is v over the four is
      //    the first occurrence in the pass.  Passes merge in increasing
      //    order with a strict <, the running (score, j) kept in the
      //    outputs.
      {
        const int i = threadIdx.x / SUB, c = threadIdx.x % SUB;
        const int iq = min(i, nq - 1);  // a spare thread repeats a query
        float v = inf_f();
        int t = 0;
        const float* row = s_part + iq * PITCH;
#pragma unroll 8
        for (int k = c; k < T; k += SUB) {
          const float x = row[k];
          t = x < v ? k : t;
          v = x < v ? x : v;
        }
#pragma unroll
        for (int o = 1; o < SUB; o <<= 1) {
          const float ov = __shfl_xor_sync(~0u, v, o);
          const int ot = __shfl_xor_sync(~0u, t, o);
          const bool take = ov < v || (ov == v && ot < t);
          v = take ? ov : v;
          t = take ? ot : t;
        }
        const float4 q = s_q[iq];
        int g_first = G;  // none
#pragma unroll
        for (int g = G - SUB + c; g >= 0; g -= SUB) {
          const int k = base + t * G + g;
          const bool real = k < M;
          const float* src = bf + (size_t)(real ? k : 0) * 3;
          const float x = src[0], y = src[1], z = src[2];
          g_first = real && score(q.x, q.y, q.z,
                                  make_float4(x, y, z,
                                              dot3(x, y, z, x, y, z))) == v
                        ? g
                        : g_first;
        }
#pragma unroll
        for (int o = 1; o < SUB; o <<= 1) {
          g_first = min(g_first, __shfl_xor_sync(~0u, g_first, o));
        }
        if (i < nq && c == 0) {
          const size_t out = (size_t)frame * N + q0 + i;
          float best = pass > 0 ? sq_out[out] : inf_f();
          int best_j = pass > 0 ? idx_out[out] : 0;
          if (g_first < G && v < best) {
            best = v;
            best_j = base + t * G + g_first;
          }
          sq_out[out] = last ? fmaxf(__fadd_rn(best, dot3(q.x, q.y, q.z,
                                                          q.x, q.y, q.z)),
                                     0.0f)
                             : best;
          idx_out[out] = best_j;
        }
      }
    }
  }
}

constexpr int NEAR_T = K4_THREADS, NEAR_G = K4_POINTS, NEAR_QC = K4_QCHUNK;

// blocks a frame: T threads of Q queries each over its N queries
int sweep_chunks(int N, int T, int Q) { return (N + T * Q - 1) / (T * Q); }

}  // namespace

// All tensors are contiguous on the device: a [B, N, 3], b and n [B, M, 3],
// sq and sdot [B, N] float32; idx [B, N] int32.  Each function launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).

extern "C" int nn_tile() { return TILE; }

extern "C" int nn_nearest_f32(const float* a, const float* b, float* sq,
                              int* idx, int B, int N, int M, void* stream) {
  if (B < 1 || N < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  nearest_kernel<NEAR_T, NEAR_G, NEAR_QC>
      <<<B, NEAR_T, 0, static_cast<cudaStream_t>(stream)>>>(a, b, sq, idx, N,
                                                            M);
  return static_cast<int>(cudaGetLastError());
}

// K3: the full sweep, K2's sweep body over every segment
extern "C" int nn_signed_f32(const float* a, const float* b, const float* n,
                             float* sq, float* sdot, int* idx, int B, int N,
                             int M, void* stream) {
  const int n_chunks = sweep_chunks(N, FULL_T, FULL_Q);
  if (B < 1 || N < 1 || M < 1 || (long long)B * n_chunks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  signed_sweep_kernel<FULL_T, FULL_Q, FULL_G, true>
      <<<B * n_chunks, FULL_T, 0, static_cast<cudaStream_t>(stream)>>>(
          a, b, n, nullptr, nullptr, nullptr, sq, sdot, idx, N, M,
          (M + TILE - 1) / TILE, n_chunks, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

// K2: the prologue writes flags, count [B] and ids [B, ceil(M / TILE)], the
// ordering kernel order [B] (int32 scratch the caller allocates), the sweep
// reads count, ids and order.
extern "C" int nn_signed_pruned_f32(const float* a, const float* b,
                                    const float* n, int* flags, int* count,
                                    int* ids, int* order, float* sq,
                                    float* sdot, int* idx, int B, int N, int M,
                                    float delta_sq, float flag_thr,
                                    void* stream) {
  const int n_seg = (M + TILE - 1) / TILE;
  const int n_chunks = sweep_chunks(N, SWEEP_T, SWEEP_Q);
  if (B < 1 || N < 1 || M < 1 || (long long)B * n_chunks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  segment_list_kernel<<<B, LIST_THREADS, 0, s>>>(a, b, flags, count, ids, N,
                                                 M, n_seg, flag_thr);
  frame_order_kernel<<<1, ORDER_THREADS, 0, s>>>(count, order, B);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  signed_sweep_kernel<SWEEP_T, SWEEP_Q, SWEEP_G, false>
      <<<B * n_chunks, SWEEP_T, 0, s>>>(a, b, n, count, ids, order, sq, sdot,
                                        idx, N, M, n_seg, n_chunks, delta_sq);
  return static_cast<int>(cudaGetLastError());
}
