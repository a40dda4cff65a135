// Ball query + group for PointNet++ stage 1 on Hopper (sm_90a): kernel K1.
//
// Replaces interdiff_tpu/ops/pallas_group.py::_select_sum_pallas together
// with the row fix-ups of its wrapper _fused_impl.  For query m of cloud b,
// slot s takes the in-radius candidate n of prefix rank s+1 (in index order,
// d2t[b, n, m] < r2); a short row repeats its first hit, a zero-hit row takes
// candidate 0, and the xyz channels are recentered on new_xyz[b, m] by one
// rounded subtraction.  The selection consumes the same d2t tensor as the
// plain PyTorch version and only copies values, so the output is
// bit-identical to it.
//
// Bound: bytes.  d2t [B, N, M] f32 is read once, up to the candidate that
// fills a query's last slot: at the main-path shape (B=32, N=2048, M=1024)
// a full read is 268 MB per radius scale, against 8 MB (S=16) and 16 MB
// (S=32) of output, about 85 us a scale at 3.35 TB/s.  Keeping HBM busy takes
// about 25 KB of loads in flight per SM (3.35 TB/s times about 1 us of
// latency, over 132 SMs); a thread that walks one query's column, each load
// behind the previous hit count, keeps one 128-byte load in flight per warp.
//
// Design: a block owns QUERIES=32 neighbouring queries of one cloud, one per
// lane, and WARPS=8 warps (grid ceil(M/32) x B: 1024 blocks of 256 threads
// at the main-path shape).  __launch_bounds__(256, 8) holds a thread to 32
// registers, so 8 blocks fit on an SM and the 1024 blocks in one wave of
// 1056 on 132 SMs.
// 1. The walk (hit_word_walk of hit_words.cuh, shared with K6), in rounds
//    of 256 candidates: per candidate one coalesced 128-byte segment of a
//    d2t row, LOADS=8 of them issued back to back and independent of one
//    another (8 x 128 B = 1 KB in flight per warp, 64 KB per SM at 8
//    blocks), folded into 32-bit hit words in shared memory ([word][query],
//    rows padded to 33: 64 words x 33 x 4 B = 8.4 KB a block at N=2048);
//    the block stops once each of its queries holds S hits.
// 2. The selection (select_hits), one warp per query (each warp takes 4):
//    a warp prefix sum of the words' popcounts ranks the hits into the
//    warp's slot list in shared memory.  Then lane l copies slots l, l+32,
//    ...: the listed candidate, the first one for the rest of a short row,
//    candidate 0 for a zero-hit row, one 16-byte load and store a slot at
//    C=4 (aligned), a warp writing 32 consecutive slots.
// No [N, M] intermediate reaches device memory.  Past 48 KB of hit words
// (N above about 11,600) the launch asks for more shared memory, up to the
// block's 227 KB.  K6 (sa.cu) walks and selects by the same header, and
// chip_smoke.py holds its grouped output bitwise against this kernel's.

#include <cuda_runtime.h>

#include <cstdint>

#include "hit_words.cuh"

namespace {

constexpr int QUERIES = HIT_QUERIES;      // queries a block, one per lane
constexpr int WARPS = 8;                  // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int ROUND = WARPS * 32;         // candidates a round
constexpr int LOADS = 8;                  // d2t loads a lane issues at once
constexpr int PITCH = HIT_PITCH;          // shared row of one hit word
constexpr int MAX_SMEM = 232448;          // a block's shared memory on sm_90

__global__ void __launch_bounds__(THREADS, 8)
    ball_group_kernel(const float* __restrict__ d2t,
                      const float* __restrict__ data,
                      const float* __restrict__ new_xyz,
                      float* __restrict__ out, int N, int M, int C, int S,
                      float r2, int n_rounds, int slot_cap) {
  extern __shared__ unsigned smem[];
  unsigned* words = smem;  // [n_rounds * WARPS][PITCH]
  int* slots = reinterpret_cast<int*>(smem + n_rounds * WARPS * PITCH);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * QUERIES;
  const bool live = m0 + lane < M;
  const size_t stride = M;
  const float* col = d2t + (size_t)b * N * stride + (m0 + lane);

  // 1. the walk: hit words, round by round, until every query is full
  const int rounds = hit_word_walk<WARPS, LOADS>(col, N, stride, S, r2, live,
                                                 words, n_rounds);

  // 2. the selection, one warp a query
  const int n_words = rounds * WARPS;
  int* list = slots + warp * slot_cap;
  const float* rows = data + (size_t)b * N * C;
  const bool vec4 = C == 4 && ((reinterpret_cast<uintptr_t>(data) |
                                reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  for (int q = warp; q < QUERIES && m0 + q < M; q += WARPS) {
    const int full = select_hits(words, n_words, q, S, list);
    const size_t query = (size_t)b * M + (m0 + q);
    const float cx = new_xyz[query * 3], cy = new_xyz[query * 3 + 1],
                cz = new_xyz[query * 3 + 2];
    float* row_out = out + query * S * C;
    for (int s = lane; s < S; s += 32) {
      const int n = s < full ? list[s] : (full > 0 ? list[0] : 0);
      if (vec4) {
        const float4 v = reinterpret_cast<const float4*>(rows)[n];
        reinterpret_cast<float4*>(row_out)[s] =
            make_float4(v.x - cx, v.y - cy, v.z - cz, v.w);
      } else {
        const float* src = rows + (size_t)n * C;
        float* dst = row_out + (size_t)s * C;
        dst[0] = src[0] - cx;
        dst[1] = src[1] - cy;
        dst[2] = src[2] - cz;
        for (int c = 3; c < C; ++c) dst[c] = src[c];
      }
    }
    __syncwarp();  // the list is read by all lanes before the next query
  }
}

}  // namespace

// d2t [B, N, M], data [B, N, C] (xyz in channels 0-2), new_xyz [B, M, 3],
// out [B, M, S, C]; all float32, contiguous, on the device.  Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int ball_group_f32(const float* d2t, const float* data,
                              const float* new_xyz, float* out, int B, int N,
                              int M, int C, int S, float r2, void* stream) {
  if (B < 1 || N < 1 || M < 1 || S < 1 || C < 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_rounds = (N + ROUND - 1) / ROUND;
  const int slot_cap = S < N ? S : N;  // a query lists at most min(S, N) hits
  const size_t smem =
      sizeof(unsigned) * ((size_t)n_rounds * WARPS * PITCH +
                          (size_t)WARPS * slot_cap);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ball_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((M + QUERIES - 1) / QUERIES, B);
  ball_group_kernel<<<grid, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      d2t, data, new_xyz, out, N, M, C, S, r2, n_rounds, slot_cap);
  return static_cast<int>(cudaGetLastError());
}
