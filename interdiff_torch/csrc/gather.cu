// Batched row gather for PointNet++ grouping on Hopper (sm_90a): kernel K5.
//
// Replaces interdiff_tpu/ops/pallas_gather.py::gather_rows_pallas
// (_gather_kernel).  out[b, k, :] = data[b, idx[b, k], :] for data [B, N, C]
// float32 with C <= 8 and idx [B, K] int32 or int64.  The TPU kernel writes
// the selection as a masked sum over all N rows because that machine has no
// gather; this card has one, so the kernel is a copy: the value is moved, not
// summed, and -0.0 stays -0.0.  An index outside [0, N) gives a zero row (no
// row matches, as in the masked sum) and nothing is read out of bounds.
//
// Bound: bytes.  idx, the output and one pass over data: at the main-path
// shape (B=32, N=2048, C=4, K=1024*32) 8.4 MB of int64 indices, 16.8 MB of
// output and 1 MB of data, about 8 us at 3.35 TB/s, which is the order of a
// kernel launch.  Design: one thread per output element, the threads of a
// warp on neighbouring (k, c), so the output is written coalesced, a row's C
// values are read by C neighbouring threads (one 16-byte segment at C=4) and
// the index, read once per element, is served from L1 for the C - 1 threads
// that repeat it.  data (1 MB) stays in L2.

#include <cuda_runtime.h>

namespace {

template <typename Index>
__global__ void gather_rows_kernel(const float* __restrict__ data,
                                   const Index* __restrict__ idx,
                                   float* __restrict__ out, int N, int C,
                                   long long K) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (e >= K * C) return;
  const long long k = e / C;
  const int c = (int)(e - k * C);
  const long long n = (long long)idx[(size_t)b * K + k];
  float v = 0.0f;
  if (n >= 0 && n < N) v = data[((size_t)b * N + n) * C + c];
  out[(size_t)b * K * C + e] = v;
}

}  // namespace

// data [B, N, C], idx [B, K] (int64 when idx_is_64, else int32), out
// [B, K, C]; contiguous, on the device.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int gather_rows_f32(const float* data, const void* idx, float* out,
                               int B, int N, int C, long long K,
                               int idx_is_64, void* stream) {
  if (B < 1 || B > 65535 || N < 1 || C < 1 || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 256;
  const long long blocks = (K * C + threads - 1) / threads;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((unsigned)blocks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_is_64) {
    gather_rows_kernel<long long><<<grid, threads, 0, s>>>(
        data, static_cast<const long long*>(idx), out, N, C, K);
  } else {
    gather_rows_kernel<int><<<grid, threads, 0, s>>>(
        data, static_cast<const int*>(idx), out, N, C, K);
  }
  return static_cast<int>(cudaGetLastError());
}
