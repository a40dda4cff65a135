// Ball query + group for PointNet++ stage 1 on Hopper (sm_90a).
//
// Replaces interdiff_tpu/ops/pallas_group.py::_select_sum_pallas together
// with the row fix-ups of its wrapper _fused_impl.  For query m of cloud b,
// slot s takes the s-th candidate n (in index order) with d2t[b, n, m] < r2;
// a short row repeats its first hit, a zero-hit row takes candidate 0, and
// the xyz channels are recentered on new_xyz[b, m].  The selection consumes
// the same d2t tensor as the plain PyTorch version and only copies values,
// so the output is bit-identical to it.
//
// Bound: bytes.  The kernel streams d2t [B, N, M] f32 once, up to the
// candidate that fills a query's last slot: at the main-path shape
// (B=32, N=2048, M=1024) a full read is 268 MB per radius scale, against
// 8 MB (S=16) and 16 MB (S=32) of output, about 83 and 85 us at 3.35 TB/s.
// Design: one thread per (b, m) query, the threads of a warp on neighbouring
// m, so each step of the walk over n reads 32 consecutive floats of a d2t
// row (coalesced).  No [N, M] intermediate is kept: the running hit count
// lives in a register and a thread stops at its S-th hit.  The walk itself is
// ball_walk.cuh, which K6 (sa.cu) shares.

#include <cuda_runtime.h>

#include "ball_walk.cuh"

namespace {

__global__ void ball_group_kernel(const float* __restrict__ d2t,
                                  const float* __restrict__ data,
                                  const float* __restrict__ new_xyz,
                                  float* __restrict__ out,
                                  int N, int M, int C, int S, float r2) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (m >= M) return;

  const float* col = d2t + (size_t)b * N * M + m;
  const float* rows = data + (size_t)b * N * C;
  const float* center = new_xyz + ((size_t)b * M + m) * 3;
  float* row_out = out + ((size_t)b * M + m) * S * C;
  const float cx = center[0], cy = center[1], cz = center[2];

  int hits = ball_walk(col, N, M, S, r2, [&](int slot, int n) {
    const float* src = rows + (size_t)n * C;
    float* dst = row_out + (size_t)slot * C;
    dst[0] = src[0] - cx;
    dst[1] = src[1] - cy;
    dst[2] = src[2] - cz;
    for (int c = 3; c < C; ++c) dst[c] = src[c];
  });

  if (hits == 0) {  // zero-hit row: candidate 0, recentered
    row_out[0] = rows[0] - cx;
    row_out[1] = rows[1] - cy;
    row_out[2] = rows[2] - cz;
    for (int c = 3; c < C; ++c) row_out[c] = rows[c];
    hits = 1;
  }
  for (int s = hits; s < S; ++s) {  // short row: repeat the first slot
    for (int c = 0; c < C; ++c) row_out[(size_t)s * C + c] = row_out[c];
  }
}

}  // namespace

// d2t [B, N, M], data [B, N, C] (xyz in channels 0-2), new_xyz [B, M, 3],
// out [B, M, S, C]; all float32, contiguous, on the device.  Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int ball_group_f32(const float* d2t, const float* data,
                              const float* new_xyz, float* out, int B, int N,
                              int M, int C, int S, float r2, void* stream) {
  const int threads = 128;
  dim3 grid((M + threads - 1) / threads, B);
  ball_group_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      d2t, data, new_xyz, out, N, M, C, S, r2);
  return static_cast<int>(cudaGetLastError());
}
