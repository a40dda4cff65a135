// One whole PointNet++ MSG radius scale on Hopper (sm_90a): kernel K6.
//
// Replaces interdiff_tpu/ops/pallas_sa.py::_sa_pallas (_make_sa_kernel, both
// with_grouped variants).  For query m of cloud b:
//   * slot s takes the s-th candidate n (in index order) with
//     d2t[b, n, m] < r2: K1's selection, the walk of ball_walk.cuh;
//   * a zero-hit row takes data row 0; a short row would repeat its first
//     hit, which feeds the chain the same input again and cannot move the
//     maximum, so only the distinct slots are evaluated;
//   * the xyz channels are recentered on new_xyz[b, m];
//   * per slot the folded conv/BN/ReLU chain runs layer by layer,
//       acc_c = sum over k, in increasing k, of W[k, c] * h[k]
//       h'_c  = max(acc_c * a_c + b_c, 0)
//     every product and sum rounded to float32 on its own (__fmul_rn,
//     __fadd_rn, __fsub_rn: the compiler may not contract them), which is the
//     arithmetic of the plain PyTorch version in ops/sa.py step by step, so
//     the two agree bit for bit;
//   * the output is the running maximum over the slots, started from 0
//     (every layer ends in ReLU);
//   * with a `grouped` pointer (the with_grouped variant, which a
//     differentiated forward asks for) the recentered chain input of every
//     slot is also written, [B, M, S, C]: the distinct slots as they are
//     evaluated, then the first slot again for the rest of a short row, so
//     that all S slots are written while each distinct one is still evaluated
//     once.  The values are K1's (ball_group.cu), bit for bit.
// Selection, fix-ups, recentering, the layer products, the affine, the ReLU
// and the maximum all happen here; d2t comes from outside and is the tensor
// that K1 and both plain versions read.
//
// Bound at the main-path shape (B=32, N=2048, M=1024, C=4): the S=16 scale
// (4->16->16->32) by bytes, 193 MB of d2t read up to each query's last slot,
// 0.06 ms at 3.35 TB/s; the S=32 scale (4->32->32->64) by operations,
// 6.7 GFLOP, 0.10 ms at 67 TFLOP/s.  On an H100 they take 1.8 and 3.2 ms:
// the walk's dependent loads (1.0 ms a scale, as in K1) and the chain's
// dependent product-and-sum steps (one warp per query, four warps a block)
// set the time.  Design: a block owns 128 neighbouring queries.
// Phase 1: one thread per query walks its d2t column (coalesced across the
// warp) and leaves the hit indices in shared memory, so no lane waits on
// another lane's chain.  Phase 2: a warp takes one query at a time, lane c
// owns output channel c (and c + 32, ...), the layer input is broadcast from
// shared memory and W[k, c] read conflict-free from the block's copy of the
// folded weights (13.8 KB for 4->32->32->64); no hidden activation
// [B, M, S, h] reaches device memory, and the grouped tensor [B, M, S, C]
// only when the caller asks for it (16 bytes a slot, written by the C lanes
// that hold the chain's input).
// Nothing of the TPU kernel's [N, TM] rank scratch, its prefix scan or its
// tile-size rule is needed here.

#include <cuda_runtime.h>

#include "ball_walk.cuh"

namespace {

constexpr int QUERIES = 128;  // queries, and threads, per block
constexpr int WARPS = QUERIES / 32;
constexpr int MAX_LAYERS = 4;
constexpr int MAX_WIDTH = 128;  // widest layer
constexpr int CHUNKS = MAX_WIDTH / 32;  // output channels per lane

struct SaShape {
  int n_layers;
  int width[MAX_LAYERS + 1];  // width[0] = C, then each layer's outputs
};

__global__ void __launch_bounds__(QUERIES)
sa_scale_kernel(const float* __restrict__ d2t, const float* __restrict__ data,
                const float* __restrict__ new_xyz,
                const float* __restrict__ params, float* __restrict__ out,
                float* __restrict__ grouped,  // [B, M, S, C] or null
                int N, int M, int C, int S, float r2, SaShape shape,
                int n_params, int buf_width) {
  extern __shared__ float smem[];
  float* s_params = smem;                                   // [n_params]
  int* s_hit = reinterpret_cast<int*>(s_params + n_params);  // [S][QUERIES]
  int* s_cnt = s_hit + S * QUERIES;                         // [QUERIES]
  float* s_act = reinterpret_cast<float*>(s_cnt + QUERIES);  // [WARPS][2][buf_width]

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * QUERIES;
  const int tid = threadIdx.x;

  for (int i = tid; i < n_params; i += QUERIES) s_params[i] = params[i];

  // phase 1: the walk, one thread per query
  if (m0 + tid < M) {
    const float* col = d2t + (size_t)b * N * M + (m0 + tid);
    s_cnt[tid] = ball_walk(col, N, M, S, r2, [&](int slot, int n) {
      s_hit[slot * QUERIES + tid] = n;
    });
  }
  __syncthreads();

  // phase 2: the chain, one warp per query, one lane per output channel
  const int warp = tid / 32, lane = tid % 32;
  const float* rows = data + (size_t)b * N * C;
  float* buf0 = s_act + warp * 2 * buf_width;
  float* buf1 = buf0 + buf_width;
  const int c_out = shape.width[shape.n_layers];

  for (int q = warp; q < QUERIES && m0 + q < M; q += WARPS) {
    const size_t query = (size_t)b * M + (m0 + q);
    const int cnt = s_cnt[q];
    const int slots = cnt > 0 ? cnt : 1;  // a zero-hit row: data row 0
    const float center = lane < 3 ? new_xyz[query * 3 + lane] : 0.0f;

    float best[CHUNKS];
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) best[j] = 0.0f;
    float first = 0.0f;  // lane c: channel c of the row's first slot

    for (int s = 0; s < slots; ++s) {
      const int n = cnt > 0 ? s_hit[s * QUERIES + q] : 0;
      if (lane < C) {
        float v = rows[(size_t)n * C + lane];
        if (lane < 3) v = __fsub_rn(v, center);
        buf0[lane] = v;
        if (s == 0) first = v;
        if (grouped) grouped[(query * S + s) * C + lane] = v;
      }
      __syncwarp();

      float* in = buf0;
      float* act = buf1;
      const float* w = s_params;
      for (int l = 0; l < shape.n_layers; ++l) {
        const int cin = shape.width[l], cout = shape.width[l + 1];
        const float* a = w + cin * cout;
        const float* bias = a + cout;
        const bool last = l == shape.n_layers - 1;
#pragma unroll
        for (int j = 0; j < CHUNKS; ++j) {
          const int c = lane + 32 * j;
          if (c < cout) {
            float acc = 0.0f;
            for (int k = 0; k < cin; ++k) {
              acc = __fadd_rn(acc, __fmul_rn(w[k * cout + c], in[k]));
            }
            const float y =
                fmaxf(__fadd_rn(__fmul_rn(acc, a[c]), bias[c]), 0.0f);
            if (last) {
              best[j] = fmaxf(best[j], y);
            } else {
              act[c] = y;
            }
          }
        }
        __syncwarp();  // the layer's output is whole before it is read
        float* read = act;
        act = in;
        in = read;
        w = bias + cout;
      }
    }

    if (grouped && lane < C) {  // a short row repeats its first slot
      for (int s = slots; s < S; ++s) {
        grouped[(query * S + s) * C + lane] = first;
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      const int c = lane + 32 * j;
      if (c < c_out) out[query * c_out + c] = best[j];
    }
  }
}

}  // namespace

extern "C" int sa_max_layers() { return MAX_LAYERS; }
extern "C" int sa_max_width() { return MAX_WIDTH; }

// d2t [B, N, M], data [B, N, C] (xyz in channels 0-2), new_xyz [B, M, 3],
// out [B, M, widths[n_layers]], grouped [B, M, S, C] or null (not written);
// params holds, layer after layer,
// W [cin, cout] row-major, a [cout], b [cout]; all float32, contiguous, on
// the device.  `widths` is a host array of n_layers + 1 ints, widths[0] = C.
// Launches on `stream` and returns a cudaError_t as an int (0 = launched).
extern "C" int sa_scale_f32(const float* d2t, const float* data,
                            const float* new_xyz, const float* params,
                            float* out, float* grouped, int B, int N, int M,
                            int C, int S,
                            float r2, int n_layers, const int* widths,
                            void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || widths[0] != C) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SaShape shape;
  shape.n_layers = n_layers;
  int n_params = 0, buf_width = C;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1 || widths[l] > MAX_WIDTH) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    shape.width[l] = widths[l];
    if (widths[l] > buf_width) buf_width = widths[l];
    if (l > 0) n_params += widths[l - 1] * widths[l] + 2 * widths[l];
  }
  for (int l = n_layers + 1; l <= MAX_LAYERS; ++l) shape.width[l] = 0;

  const size_t bytes =
      sizeof(float) * ((size_t)n_params + (size_t)S * QUERIES + QUERIES +
                       (size_t)WARPS * 2 * buf_width);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sa_scale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the next launch starts clean
      return static_cast<int>(err);
    }
  }
  dim3 grid((M + QUERIES - 1) / QUERIES, B);
  sa_scale_kernel<<<grid, QUERIES, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      d2t, data, new_xyz, params, out, grouped, N, M, C, S, r2, shape,
      n_params, buf_width);
  return static_cast<int>(cudaGetLastError());
}
