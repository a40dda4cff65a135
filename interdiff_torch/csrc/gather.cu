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
// output and 1 MB of data, 26.2 MB or 7.8 us at 3.35 TB/s, the order of a
// kernel launch.  Design: one thread per row (b, k), which reads its index
// once and copies the row: at C = 4 with 16-byte-aligned data and output as
// one float4 load and one float4 store (a warp writes 512 contiguous bytes),
// otherwise C scalars in order.  The kernel is a template on C, so the row
// loop unrolls and no division is left; data (1 MB) stays in L2.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

template <int C, bool VEC, typename Index>
__global__ void __launch_bounds__(THREADS)
    gather_rows_kernel(const float* __restrict__ data,
                       const Index* __restrict__ idx, float* __restrict__ out,
                       int N, long long K) {
  const long long k = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (k >= K) return;
  const size_t row = (size_t)blockIdx.y * K + k;
  const long long n = (long long)idx[row];
  const bool in = n >= 0 && n < N;
  const size_t src = (size_t)blockIdx.y * N + n;
  if (VEC) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (in) v = reinterpret_cast<const float4*>(data)[src];
    reinterpret_cast<float4*>(out)[row] = v;
  } else if (in) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[row * C + c] = data[src * C + c];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) out[row * C + c] = 0.0f;
  }
}

template <int C, bool VEC>
void launch_c(const float* data, const void* idx, float* out, int N,
              long long K, int idx_is_64, dim3 grid, cudaStream_t s) {
  if (idx_is_64) {
    gather_rows_kernel<C, VEC, long long><<<grid, THREADS, 0, s>>>(
        data, static_cast<const long long*>(idx), out, N, K);
  } else {
    gather_rows_kernel<C, VEC, int><<<grid, THREADS, 0, s>>>(
        data, static_cast<const int*>(idx), out, N, K);
  }
}

}  // namespace

// data [B, N, C], idx [B, K] (int64 when idx_is_64, else int32), out
// [B, K, C]; contiguous, on the device.  Launches on `stream` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int gather_rows_f32(const float* data, const void* idx, float* out,
                               int B, int N, int C, long long K,
                               int idx_is_64, void* stream) {
  const long long blocks = (K + THREADS - 1) / THREADS;
  if (B < 1 || B > 65535 || N < 1 || C < 1 || C > 8 || K < 1 ||
      blocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((unsigned)blocks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = ((reinterpret_cast<uintptr_t>(data) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  switch (C) {
    case 1: launch_c<1, false>(data, idx, out, N, K, idx_is_64, grid, s); break;
    case 2: launch_c<2, false>(data, idx, out, N, K, idx_is_64, grid, s); break;
    case 3: launch_c<3, false>(data, idx, out, N, K, idx_is_64, grid, s); break;
    case 4:
      if (aligned) {
        launch_c<4, true>(data, idx, out, N, K, idx_is_64, grid, s);
      } else {
        launch_c<4, false>(data, idx, out, N, K, idx_is_64, grid, s);
      }
      break;
    case 5: launch_c<5, false>(data, idx, out, N, K, idx_is_64, grid, s); break;
    case 6: launch_c<6, false>(data, idx, out, N, K, idx_is_64, grid, s); break;
    case 7: launch_c<7, false>(data, idx, out, N, K, idx_is_64, grid, s); break;
    default: launch_c<8, false>(data, idx, out, N, K, idx_is_64, grid, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
