// One whole PointNet++ MSG radius scale on Hopper (sm_90a): kernel K6.
//
// Replaces interdiff_tpu/ops/pallas_sa.py::_sa_pallas (_make_sa_kernel, both
// with_grouped variants).  For query m of cloud b:
//   * slot s takes the s-th candidate n (in index order) with
//     d2t[b, n, m] < r2: K1's selection, by the walk and selection of
//     hit_words.cuh, which ball_group.cu (K1) runs too;
//   * a zero-hit row takes data row 0; a short row repeats its first hit,
//     which feeds the chain the same input again and cannot move the
//     maximum;
//   * the xyz channels are recentered on new_xyz[b, m] by one rounded
//     subtraction;
//   * per slot the folded conv/BN/ReLU chain runs layer by layer,
//       acc_c = sum over k, in increasing k, of W[k, c] * h[k]
//       h'_c  = max(acc_c * a_c + b_c, 0)
//     every product and sum rounded to float32 on its own (__fmul_rn,
//     __fadd_rn, __fsub_rn: the compiler may not contract them), which is the
//     arithmetic of the plain PyTorch version in ops/sa.py step by step, so
//     the two agree bit for bit;
//   * the output is the maximum over the slots of max(0, h) (every layer
//     ends in ReLU), exact in any order;
//   * with a `grouped` pointer (the with_grouped variant, which a
//     differentiated forward asks for) the recentered chain input of every
//     slot is also written, [B, M, S, C], bit for bit K1's output.
// d2t comes from outside and is the tensor that K1 and both plain versions
// read.
//
// Bound at the main-path shape (B=32, N=2048, M=1024, C=4): the S=16 scale
// (4->16->16->32) by bytes, d2t read up to each query's last slot; the S=32
// scale (4->32->32->64) by operations, 6.7 GFLOP at 67 TFLOP/s.  Under the
// bitwise contract every product and sum is one instruction (no FMA), so
// the issue rate of the card (about 33.5e12 float32 instructions/s) puts
// the S=32 chain's floor near 0.20 ms.
//
// Design: a block owns QUERIES=32 neighbouring queries of one cloud and 8
// warps (grid ceil(M/32) x B), as K1.
// 1. The walk and the selection of hit_words.cuh: the 8 warps read d2t in
//    hit words, K6_LOADS coalesced 128-byte loads in flight a lane, until
//    every query of the block holds S hits; then each warp ranks the hits
//    of 4 queries into slot lists in shared memory.  The folded weights are
//    copied to shared memory meanwhile.
// 2. The chain, at the encoder's two shapes (C=4 with 16,16,32 at S=16 and
//    32,32,64 at S=32; sa_lane_kernel): one lane per slot, so a warp takes
//    32/S queries at once and every lane is busy.  A lane holds its slot's
//    activations in registers, layer after layer, and each output channel
//    its own accumulator: COUT independent chains of CIN rounded product
//    and sum steps.  The weights are read as broadcast 16-byte loads from
//    the block's shared copy (one load feeds four products).  The last
//    layer runs in chunks of 16 channels; the maximum over the slots folds
//    the chunk across the S lanes by halves (each exchange keeps half of
//    the channels), so each lane ends with one channel's maximum and the
//    lanes write the chunk together.  Short rows evaluate the repeated
//    first hit in the remaining lanes: the same inputs give the same
//    values, so the maximum is unchanged.
//    Any other shape (runtime widths up to MAX_LAYERS x MAX_WIDTH, C from
//    3 to 8; sa_generic_kernel) runs the chain one warp per query and one
//    lane per output channel over its distinct slots, the layer's input
//    broadcast from shared memory.
// No hidden activation [B, M, S, h] reaches device memory, and the grouped
// tensor only when the caller asks for it.

#include <cuda_runtime.h>

#include "hit_words.cuh"

namespace {

constexpr int QUERIES = HIT_QUERIES;  // queries a block
constexpr int WARPS = 8;              // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int ROUND = WARPS * 32;     // candidates a round of the walk
constexpr int MAX_LAYERS = 4;
constexpr int MAX_WIDTH = 128;        // widest layer
constexpr int CHUNKS = MAX_WIDTH / 32;  // output channels per lane (generic)
constexpr int CHUNK = 16;             // last-layer channels a step (lane kernel)
constexpr int MAX_SMEM = 232448;      // a block's shared memory on sm_90
// loads in flight a lane in the walk, and the blocks an SM the lane
// kernel's registers are held to; scripts/torch_kernel_probes.py rebuilds
// the library with -DK6_LOADS and -DK6_MIN_BLOCKS to time other settings
#ifndef K6_LOADS
#define K6_LOADS 8
#endif
#ifndef K6_MIN_BLOCKS
#define K6_MIN_BLOCKS 3
#endif

struct SaShape {
  int n_layers;
  int width[MAX_LAYERS + 1];  // width[0] = C, then each layer's outputs
};

// Shared memory of a block: the folded weights [n_params], the hit words
// [n_rounds * WARPS][HIT_PITCH], the slot lists [QUERIES][slot_cap] and the
// hit counts [QUERIES], then the generic kernel's activation rows.
struct Smem {
  float* params;
  unsigned* words;
  int* lists;
  int* cnt;
  float* act;
};

__device__ __forceinline__ Smem carve(float* smem, int n_params, int n_rounds,
                                      int slot_cap) {
  Smem s;
  s.params = smem;
  s.words = reinterpret_cast<unsigned*>(smem + n_params);
  s.lists = reinterpret_cast<int*>(s.words + n_rounds * WARPS * HIT_PITCH);
  s.cnt = s.lists + QUERIES * slot_cap;
  s.act = reinterpret_cast<float*>(s.cnt + QUERIES);
  return s;
}

// Phase 1 of both kernels: the weights to shared memory, the walk, and the
// slot list and hit count (at most S) of each of the block's queries.
__device__ __forceinline__ void walk_and_select(
    const Smem& sm, const float* __restrict__ d2t,
    const float* __restrict__ params, int n_params, int N, int M, int S,
    float r2, int n_rounds, int slot_cap) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * QUERIES;
  for (int i = threadIdx.x; i < n_params; i += THREADS) {
    sm.params[i] = params[i];
  }
  const bool live = m0 + lane < M;
  const size_t stride = M;
  const float* col = d2t + (size_t)b * N * stride + (m0 + lane);
  const int rounds = hit_word_walk<WARPS, K6_LOADS>(col, N, stride, S, r2,
                                                    live, sm.words, n_rounds);
  for (int q = warp; q < QUERIES; q += WARPS) {
    int full = 0;
    if (m0 + q < M) {
      full = select_hits(sm.words, rounds * WARPS, q, S,
                         sm.lists + q * slot_cap);
    }
    if (lane == 0) sm.cnt[q] = full;
  }
  __syncthreads();
}

// out = max(a * (in @ W) + b, 0), W [CIN, COUT] row-major in shared memory,
// each channel's sum in increasing k, every step rounded on its own
template <int CIN, int COUT>
__device__ __forceinline__ void dense_relu(const float (&in)[CIN],
                                           const float* w, const float* a,
                                           const float* bias,
                                           float (&out)[COUT]) {
  static_assert(COUT % 4 == 0, "rows of W are read as float4");
#pragma unroll
  for (int c = 0; c < COUT; ++c) out[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < CIN; ++k) {
    const float4* wk = reinterpret_cast<const float4*>(w + k * COUT);
#pragma unroll
    for (int c4 = 0; c4 < COUT / 4; ++c4) {
      const float4 v = wk[c4];
      out[4 * c4] = __fadd_rn(out[4 * c4], __fmul_rn(v.x, in[k]));
      out[4 * c4 + 1] = __fadd_rn(out[4 * c4 + 1], __fmul_rn(v.y, in[k]));
      out[4 * c4 + 2] = __fadd_rn(out[4 * c4 + 2], __fmul_rn(v.z, in[k]));
      out[4 * c4 + 3] = __fadd_rn(out[4 * c4 + 3], __fmul_rn(v.w, in[k]));
    }
  }
#pragma unroll
  for (int c = 0; c < COUT; ++c) {
    out[c] = fmaxf(__fadd_rn(__fmul_rn(out[c], a[c]), bias[c]), 0.0f);
  }
}

// The maximum of y[0, N) over the lanes of a group (offsets O, O/2, ..., 1
// within it): while N > 1 each exchange keeps half of the channels, the
// upper half on the lane whose bit O is set (base moves up by N/2), and
// takes the maximum with the partner's copy of that half; once one channel
// is left the remaining offsets fold it.  On return y[0, N >> steps) are
// the group's maxima of channels base, base + 1, ...
template <int N, int O>
struct FoldMax {
  static __device__ __forceinline__ void run(float* y, int lane, int& base) {
    if constexpr (O > 0) {
      if constexpr (N == 1) {
        y[0] = fmaxf(y[0], __shfl_xor_sync(~0u, y[0], O));
        FoldMax<1, O / 2>::run(y, lane, base);
      } else {
        constexpr int H = N / 2;
        const bool up = (lane & O) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float send = up ? y[i] : y[i + H];
          const float keep = up ? y[i + H] : y[i];
          y[i] = fmaxf(keep, __shfl_xor_sync(~0u, send, O));
        }
        if (up) base += H;
        FoldMax<H, O / 2>::run(y, lane, base);
      }
    }
  }
};

// The encoder's shapes: C data channels, layers C -> W1 -> W2 -> W3, S
// slots, one lane per slot (see the top of the file).
template <int C, int W1, int W2, int W3, int S>
__global__ void __launch_bounds__(THREADS, K6_MIN_BLOCKS)
    sa_lane_kernel(const float* __restrict__ d2t,
                   const float* __restrict__ data,
                   const float* __restrict__ new_xyz,
                   const float* __restrict__ params, float* __restrict__ out,
                   float* __restrict__ grouped,  // [B, M, S, C] or null
                   int N, int M, float r2, int n_params, int n_rounds,
                   int slot_cap) {
  static_assert(32 % S == 0 && W3 % CHUNK == 0, "lanes split into slots");
  extern __shared__ float4 smem4[];
  const Smem sm = carve(reinterpret_cast<float*>(smem4), n_params, n_rounds,
                        slot_cap);
  walk_and_select(sm, d2t, params, n_params, N, M, S, r2, n_rounds,
                  slot_cap);

  constexpr int PER_WARP = 32 / S;  // queries a warp takes at once
  constexpr int NF = CHUNK > S ? CHUNK / S : 1;  // channels a lane writes
  constexpr int DUP = S > CHUNK ? S / CHUNK : 1;  // lanes holding each
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = lane % S;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * QUERIES;
  const float* rows = data + (size_t)b * N * C;
  const float* w1 = sm.params;
  const float* a1 = w1 + C * W1;
  const float* b1 = a1 + W1;
  const float* w2 = b1 + W1;
  const float* a2 = w2 + W1 * W2;
  const float* b2 = a2 + W2;
  const float* w3 = b2 + W2;
  const float* a3 = w3 + W2 * W3;
  const float* b3 = a3 + W3;

  for (int q0 = warp * PER_WARP; q0 < QUERIES; q0 += WARPS * PER_WARP) {
    const int q = q0 + lane / S;
    const bool live = m0 + q < M;  // every lane runs the chain; live ones store
    const size_t query = (size_t)b * M + (m0 + q);
    int n = 0;
    float h0[C];
    if (live) {
      const int cnt = sm.cnt[q];
      const int* list = sm.lists + q * slot_cap;
      n = s < cnt ? list[s] : (cnt > 0 ? list[0] : 0);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float v = rows[(size_t)n * C + c];
      h0[c] = c < 3 ? __fsub_rn(v, live ? new_xyz[query * 3 + c] : 0.0f) : v;
    }
    if (grouped && live) {
#pragma unroll
      for (int c = 0; c < C; ++c) grouped[(query * S + s) * C + c] = h0[c];
    }
    float h1[W1], h2[W2];
    dense_relu<C, W1>(h0, w1, a1, b1, h1);
    dense_relu<W1, W2>(h1, w2, a2, b2, h2);
#pragma unroll 1
    for (int c0 = 0; c0 < W3; c0 += CHUNK) {
      float y[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) y[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < W2; ++k) {
        const float4* wk = reinterpret_cast<const float4*>(w3 + k * W3 + c0);
#pragma unroll
        for (int j4 = 0; j4 < CHUNK / 4; ++j4) {
          const float4 v = wk[j4];
          y[4 * j4] = __fadd_rn(y[4 * j4], __fmul_rn(v.x, h2[k]));
          y[4 * j4 + 1] = __fadd_rn(y[4 * j4 + 1], __fmul_rn(v.y, h2[k]));
          y[4 * j4 + 2] = __fadd_rn(y[4 * j4 + 2], __fmul_rn(v.z, h2[k]));
          y[4 * j4 + 3] = __fadd_rn(y[4 * j4 + 3], __fmul_rn(v.w, h2[k]));
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        // the running maximum starts from +0.0, as the slot loop of the
        // generic kernel does
        y[j] = fmaxf(0.0f, fmaxf(__fadd_rn(__fmul_rn(y[j], a3[c0 + j]),
                                           b3[c0 + j]), 0.0f));
      }
      int base = 0;
      FoldMax<CHUNK, S / 2>::run(y, lane, base);
      if (live && s % DUP == 0) {
#pragma unroll
        for (int i = 0; i < NF; ++i) out[query * W3 + c0 + base + i] = y[i];
      }
    }
  }
}

// Any shape: one warp per query, lane c owns output channel c (and c + 32,
// ...), over the query's distinct slots.
__global__ void __launch_bounds__(THREADS)
    sa_generic_kernel(const float* __restrict__ d2t,
                      const float* __restrict__ data,
                      const float* __restrict__ new_xyz,
                      const float* __restrict__ params,
                      float* __restrict__ out,
                      float* __restrict__ grouped,  // [B, M, S, C] or null
                      int N, int M, int C, int S, float r2, SaShape shape,
                      int n_params, int n_rounds, int slot_cap,
                      int buf_width) {
  extern __shared__ float4 smem4[];
  const Smem sm = carve(reinterpret_cast<float*>(smem4), n_params, n_rounds,
                        slot_cap);
  walk_and_select(sm, d2t, params, n_params, N, M, S, r2, n_rounds,
                  slot_cap);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * QUERIES;
  const float* rows = data + (size_t)b * N * C;
  float* buf0 = sm.act + warp * 2 * buf_width;
  float* buf1 = buf0 + buf_width;
  const int c_out = shape.width[shape.n_layers];

  for (int q = warp; q < QUERIES && m0 + q < M; q += WARPS) {
    const size_t query = (size_t)b * M + (m0 + q);
    const int cnt = sm.cnt[q];
    const int* list = sm.lists + q * slot_cap;
    const int slots = cnt > 0 ? cnt : 1;  // a zero-hit row: data row 0
    const float center = lane < 3 ? new_xyz[query * 3 + lane] : 0.0f;

    float best[CHUNKS];
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) best[j] = 0.0f;
    float first = 0.0f;  // lane c: channel c of the row's first slot

    for (int s = 0; s < slots; ++s) {
      const int n = cnt > 0 ? list[s] : 0;
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
      const float* w = sm.params;
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

// the lane kernel for these widths, or null
using LaneKernel = void (*)(const float*, const float*, const float*,
                            const float*, float*, float*, int, int, float,
                            int, int, int);

LaneKernel lane_kernel(const int* widths, int n_layers, int S) {
  if (n_layers != 3 || widths[0] != 4) return nullptr;
  if (S == 16 && widths[1] == 16 && widths[2] == 16 && widths[3] == 32) {
    return sa_lane_kernel<4, 16, 16, 32, 16>;
  }
  if (S == 32 && widths[1] == 32 && widths[2] == 32 && widths[3] == 64) {
    return sa_lane_kernel<4, 32, 32, 64, 32>;
  }
  return nullptr;
}

template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) cudaGetLastError();  // the next launch starts clean
  return err;
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
  if (n_layers < 1 || n_layers > MAX_LAYERS || widths[0] != C || B < 1 ||
      N < 1 || M < 1 || S < 1 || C < 3) {
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

  const int n_rounds = (N + ROUND - 1) / ROUND;
  const int slot_cap = S < N ? S : N;  // a query lists at most min(S, N) hits
  const size_t base = sizeof(float) * ((size_t)n_params +
                                       (size_t)n_rounds * WARPS * HIT_PITCH +
                                       (size_t)QUERIES * slot_cap + QUERIES);
  const dim3 grid((M + QUERIES - 1) / QUERIES, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LaneKernel lane = lane_kernel(widths, n_layers, S);
  if (lane != nullptr) {
    if (base > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_smem(lane, base);
    if (err != cudaSuccess) return static_cast<int>(err);
    lane<<<grid, THREADS, base, s>>>(d2t, data, new_xyz, params, out,
                                     grouped, N, M, r2, n_params, n_rounds,
                                     slot_cap);
  } else {
    const size_t bytes = base + sizeof(float) * WARPS * 2 * buf_width;
    if (bytes > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_smem(sa_generic_kernel, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sa_generic_kernel<<<grid, THREADS, bytes, s>>>(
        d2t, data, new_xyz, params, out, grouped, N, M, C, S, r2, shape,
        n_params, n_rounds, slot_cap, buf_width);
  }
  return static_cast<int>(cudaGetLastError());
}
