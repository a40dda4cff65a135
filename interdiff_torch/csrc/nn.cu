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
// Pruning (K2): the surface is cut into segments of TILE points, the unit the
// block stages through shared memory anyway.  flags[f, s] != 0 says that some
// point of segment s of frame f lies within delta of the bounding box of the
// frame's queries (computed by the wrapper in plain PyTorch, O(M) per frame);
// the block skips the other segments whole.  A query whose nearest point is
// closer than delta always finds it in a flagged segment, so the result is
// bit-equal to the full sweep there; every query with sq >= delta^2, those
// with no flagged segment included (the running minimum starts at 3.0e38),
// gets exactly (delta^2, +1, 0).  Flags are per frame and the segment is one
// shared-memory tile: nothing here needs the blocks of eight frames, the few
// wide segments or the padded tensors that the TPU's tiling asked for.  The
// ragged last tile and the ragged last query block are masked in the kernel.
//
// Bound: operations, not bytes.  At the gate's shape (1600 frames, N=2048
// queries, M=6890 points) a full sweep is 2.26e10 pairs of 8 float32
// operations against 0.17 GB of input.  Design: one block per (frame, 128
// queries), one thread per query with (best, j*) in registers; the block
// stages TILE points of b as float4 (x, y, z, b2) in shared memory, so the
// inner loop costs one broadcast 16-byte shared load and eight arithmetic
// instructions per pair and no global traffic; n is read only once, at j*.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // queries per block
constexpr int TILE = 256;     // surface points per shared-memory tile = pruning segment
constexpr float SCORE_INF = 3.0e38f;  // beats no real score

__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

template <bool SIGNED, bool PRUNED>
__global__ void nn_sweep_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                const float* __restrict__ n,
                                const int* __restrict__ flags,
                                float* __restrict__ sq_out,
                                float* __restrict__ sdot_out,
                                int* __restrict__ idx_out,
                                int N, int M, float delta_sq) {
  __shared__ float4 tile[TILE];

  const int frame = blockIdx.x;
  const int q = blockIdx.y * THREADS + threadIdx.x;
  const bool live = q < N;
  const float* bf = b + (size_t)frame * M * 3;
  const int n_seg = (M + TILE - 1) / TILE;

  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  if (live) {
    const float* ap = a + ((size_t)frame * N + q) * 3;
    ax = ap[0];
    ay = ap[1];
    az = ap[2];
  }

  float best = SCORE_INF;
  int best_j = 0;
  for (int seg = 0; seg < n_seg; ++seg) {
    // the flag is the same for every thread of the block
    if (PRUNED && flags[(size_t)frame * n_seg + seg] == 0) continue;
    const int base = seg * TILE;
    const int count = min(TILE, M - base);
    __syncthreads();  // the previous tile has been read by every thread
    for (int k = threadIdx.x; k < count; k += THREADS) {
      const float* p = bf + (size_t)(base + k) * 3;
      const float x = p[0], y = p[1], z = p[2];
      tile[k] = make_float4(x, y, z, dot3(x, y, z, x, y, z));
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int k = 0; k < count; ++k) {
        const float4 c = tile[k];
        const float score = __fmaf_rn(-2.0f, dot3(ax, ay, az, c.x, c.y, c.z),
                                      c.w);
        if (score < best) {
          best = score;
          best_j = base + k;
        }
      }
    }
  }
  if (!live) return;

  const size_t out = (size_t)frame * N + q;
  float sq = fmaxf(__fadd_rn(best, dot3(ax, ay, az, ax, ay, az)), 0.0f);
  float sdot = 1.0f;
  if (SIGNED) {
    const size_t j = ((size_t)frame * M + best_j) * 3;
    const float bx = b[j], by = b[j + 1], bz = b[j + 2];
    const float nx = n[j], ny = n[j + 1], nz = n[j + 2];
    sdot = __fsub_rn(dot3(ax, ay, az, nx, ny, nz),
                     dot3(nx, ny, nz, bx, by, bz));
  }
  if (PRUNED && sq >= delta_sq) {
    sq = delta_sq;
    sdot = 1.0f;
    best_j = 0;
  }
  sq_out[out] = sq;
  idx_out[out] = best_j;
  if (SIGNED) sdot_out[out] = sdot;
}

dim3 sweep_grid(int B, int N) { return dim3(B, (N + THREADS - 1) / THREADS); }

}  // namespace

// All tensors are contiguous on the device: a [B, N, 3], b and n [B, M, 3],
// sq and sdot [B, N] float32; idx [B, N] and flags [B, ceil(M / TILE)] int32.
// Each function launches on `stream` and returns cudaGetLastError() as an int
// (0 = launched).

extern "C" int nn_tile() { return TILE; }

extern "C" int nn_nearest_f32(const float* a, const float* b, float* sq,
                              int* idx, int B, int N, int M, void* stream) {
  nn_sweep_kernel<false, false>
      <<<sweep_grid(B, N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          a, b, nullptr, nullptr, sq, nullptr, idx, N, M, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nn_signed_f32(const float* a, const float* b, const float* n,
                             float* sq, float* sdot, int* idx, int B, int N,
                             int M, void* stream) {
  nn_sweep_kernel<true, false>
      <<<sweep_grid(B, N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          a, b, n, nullptr, sq, sdot, idx, N, M, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nn_signed_pruned_f32(const float* a, const float* b,
                                    const float* n, const int* flags,
                                    float* sq, float* sdot, int* idx, int B,
                                    int N, int M, float delta_sq,
                                    void* stream) {
  nn_sweep_kernel<true, true>
      <<<sweep_grid(B, N), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          a, b, n, flags, sq, sdot, idx, N, M, delta_sq);
  return static_cast<int>(cudaGetLastError());
}
