// Multi-head self-attention read from a packed QKV product on Hopper
// (sm_90a): kernel K7.
//
// Replaces no Pallas kernel: the JAX package leaves dense attention to XLA
// (interdiff_tpu/ops/attention.py::multi_head_attention).  It was added for
// MDM's encoder layers (interdiff_torch/models/layers.py::
// PackedEncoderLayer), the attention over 197 tokens at head size 128 of
// the text-to-motion denoiser.  There the library route copies q, k and v
// into [B*H, T, hd] batches, writes [B, H, T, T] scores, scales and
// softmaxes them in passes of their own and copies the output back to
// [B, T, D]: some 2 ms of memory traffic a guided step on the card.
//
// out[b, t, h*hd + c] = sum_k softmax_k(scale * q_t . k_k + mask[t, k])
// v_k[c], with q, k and v read in place from qkv [B, T, 3D] (q | k | v
// columns, head h at columns h*hd of each) and the output written heads
// concatenated, [B, T, D], the layout `out_proj` reads.  float32 and FFMA
// throughout: no TF32, no reduced precision; the sums are taken in another
// order than the library's.
//
// Bound: operations.  4 B H T^2 hd FLOPs: 5.09 GFLOP at MDM's guided shape
// (B=64, T=197, H=4, hd=128) against 103 MB of qkv in and output out, 76 us
// at 67 TFLOP/s against 31 us at 3.35 TB/s.  On the card the limit is
// shared memory's delivery of operands to the FFMAs (128 bytes a clock an
// SM, as many as the FFMAs' lanes a clock), so the design counts bytes read
// from shared memory per FFMA.  One block of 128 threads for each (query
// tile of 64 rows, head, batch row), 1,024 blocks at that shape.  The query
// tile stays in shared memory; K and V stream in tiles of 32 keys by
// cp.async, each load overlapping the other product (V_j lands while the
// scores of K_j are formed, K_{j+1} while P_j V_j is summed), so one buffer
// each does; 76 KB a block, two blocks an SM.  A thread holds 4 query rows
// (rg + 16i) by 4 keys (kg + 8j) of the scores and the same 4 rows by 16
// output columns (4 kg + 32c, as float4): each float4 read from shared
// memory feeds 8 (scores) or 12.8 (output) FFMAs, and the row strides
// (hd + 4, 32 + 8 floats) keep every read and write of a warp free of bank
// conflicts.  Larger register tiles (8 rows by 4 keys and by 8 columns)
// ran no faster: at 255 registers they leave one block of 8 warps an SM.
// The softmax is online (flash attention): a row's running max and sum,
// reduced over the 8 lanes that share the row by shuffles, rescale the
// output accumulators from tile to tile; P goes through shared memory
// (10 KB) only, never to device memory.  Ragged edges cost no full tile: a
// block whose query tile holds r valid rows runs ceil(r / 16) row slots (a
// template), the last key tile ceil(keys / 8) key slots of the scores and
// ceil(keys / 4) keys of the output sum.  At T = 197 that is 208 rows and
// 200 keys computed of 197, where whole tiles would compute 256 and 224.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// The block's geometry (the note above): RG row groups by KG key groups of
// threads, MI query rows (rg + RG i) and MJ keys (kg + KG j) a thread.
constexpr int HD = 128;  // head size, MDM's
constexpr int RG = 16;
constexpr int KG = 8;
constexpr int MI = 4;
constexpr int MJ = 4;
constexpr int THREADS = RG * KG;
constexpr int BQ = RG * MI;  // query rows a block
constexpr int BK = KG * MJ;  // keys a tile
constexpr int PS = BK + KG;  // row stride of the P tile, floats
static_assert(KG == 8 || KG == 16, "a row's key groups share a warp");
static_assert(THREADS % 32 == 0 && BK % 32 == 0, "whole warps, P's banks");

// Q, K and V tiles of row stride HD + 4, then the P tile
constexpr int SMEM_BYTES =
    static_cast<int>(sizeof(float)) * ((BQ + 2 * BK) * (HD + 4) + BQ * PS);

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows of HD floats, row r from base + (row0 + r) * stride, into a
// tile of row stride HD + 4; rows at or past T are zero-filled (nothing
// read).
template <int ROWS>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          int row0, int T, long long stride) {
  constexpr int V4 = HD / 4;  // float4 a row
  static_assert(ROWS * V4 % THREADS == 0, "whole float4 a thread");
#pragma unroll
  for (int n = 0; n < ROWS * V4 / THREADS; ++n) {
    const int f = n * THREADS + threadIdx.x;
    const int r = f / V4, c = (f % V4) * 4;
    const bool in = row0 + r < T;
    cp_async16(tile + r * (HD + 4) + c,
               in ? base + (long long)(row0 + r) * stride + c : base, in);
  }
}

// s[i][j] = q_{rg+RG i} . k_{kg+KG j} for i < NI, j < NJ, summed over d in
// order.
template <int NI, int NJ>
__device__ __forceinline__ void scores_nj(const float* Qs, const float* Ks,
                                          int rg, int kg,
                                          float (&s)[NI][MJ]) {
  float acc[NI][NJ];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 q[NI], k[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      q[i] = *reinterpret_cast<const float4*>(Qs + (rg + RG * i) * (HD + 4) +
                                              d);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      k[j] = *reinterpret_cast<const float4*>(Ks + (kg + KG * j) * (HD + 4) +
                                              d);
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float a = acc[i][j];
        a = fmaf(q[i].x, k[j].x, a);
        a = fmaf(q[i].y, k[j].y, a);
        a = fmaf(q[i].z, k[j].z, a);
        acc[i][j] = fmaf(q[i].w, k[j].w, a);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = acc[i][j];
  }
}

// scores_nj with NJ = nj, the key slots that hold a key of the tile.
template <int NI, int NJ = MJ>
__device__ __forceinline__ void scores(int nj, const float* Qs,
                                       const float* Ks, int rg, int kg,
                                       float (&s)[NI][MJ]) {
  if constexpr (NJ == 1) {
    scores_nj<NI, 1>(Qs, Ks, rg, kg, s);
  } else {
    if (nj == NJ) {
      scores_nj<NI, NJ>(Qs, Ks, rg, kg, s);
    } else {
      scores<NI, NJ - 1>(nj, Qs, Ks, rg, kg, s);
    }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// One block's query tile with NI row slots a thread.
template <int NI>
__device__ __forceinline__ void attend(const float* __restrict__ qkv,
                                       const float* __restrict__ mask,
                                       float* __restrict__ out, int T, int H,
                                       float scale, float* smem) {
  constexpr int RS = HD + 4;
  constexpr int NC = HD / (4 * KG);  // float4 column chunks of the output
  float* Qs = smem;
  float* Ks = Qs + BQ * RS;
  float* Vs = Ks + BK * RS;
  float* Ps = Vs + BK * RS;
  const int D = H * HD;
  const long long stride = 3LL * D;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * BQ;
  const float* base = qkv + (long long)b * T * stride + h * HD;
  const int lane = threadIdx.x & 31;
  const int kg = lane % KG;
  const int rg = (threadIdx.x >> 5) * (32 / KG) + lane / KG;

  float o[NI][NC][4];
  float m[NI], l[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.0f;
    }
  }

  load_tile<BQ>(Qs, base, r0, T, stride);
  load_tile<BK>(Ks, base + D, 0, T, stride);
  cp_async_commit();
  const int n_tiles = (T + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    const int keys = min(BK, T - k0);
    cp_async_wait<0>();  // K_kt (and at first Q)
    __syncthreads();     // ... for every thread; P_{kt-1} V_{kt-1} done
    load_tile<BK>(Vs, base + 2 * D, k0, T, stride);
    cp_async_commit();

    float s[NI][MJ];
    scores<NI>((keys + KG - 1) / KG, Qs, Ks, rg, kg, s);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int row = r0 + rg + RG * i;
      const float* mrow =
          mask != nullptr && row < T ? mask + (long long)row * T + k0 : nullptr;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const int key = kg + KG * j;  // slots past NJ hold no key
        float v = -INFINITY;
        if (key < keys) {
          v = s[i][j] * scale;
          if (mrow != nullptr) v += mrow[key];
        }
        s[i][j] = v;
        mt = fmaxf(mt, v);
      }
#pragma unroll
      for (int w = 1; w < KG; w *= 2) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      }
      const float mn = fmaxf(m[i], mt);
      const bool none = mn == -INFINITY;  // every key so far masked out
      const float alpha = none ? 1.0f : expf(m[i] - mn);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < MJ; ++j) {
        const float p = none ? 0.0f : expf(s[i][j] - mn);
        Ps[(rg + RG * i) * PS + kg + KG * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < KG; w *= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
      }
    }
    __syncthreads();  // P_kt written; every thread done with K_kt
    if (kt + 1 < n_tiles) load_tile<BK>(Ks, base + D, k0 + BK, T, stride);
    cp_async_commit();
    cp_async_wait<1>();  // V_kt (K_{kt+1} may still be in flight)
    __syncthreads();

    // O += P V over the tile's keys, four at a time (P is 0 and V is
    // zero-filled past the last key)
    const int k4s = (keys + 3) >> 2;
    for (int k4 = 0; k4 < k4s; ++k4) {
      float4 p[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        p[i] = *reinterpret_cast<const float4*>(Ps + (rg + RG * i) * PS +
                                                4 * k4);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (4 * k4 + e) * RS + 4 * kg;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 v =
              *reinterpret_cast<const float4*>(vrow + 4 * KG * c);
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            const float pk = lane_of(p[i], e);
            o[i][c][0] = fmaf(pk, v.x, o[i][c][0]);
            o[i][c][1] = fmaf(pk, v.y, o[i][c][1]);
            o[i][c][2] = fmaf(pk, v.z, o[i][c][2]);
            o[i][c][3] = fmaf(pk, v.w, o[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = r0 + rg + RG * i;
    if (row >= T) continue;
    float* dst = out + ((long long)b * T + row) * D + h * HD + 4 * kg;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      *reinterpret_cast<float4*>(dst + 4 * KG * c) =
          make_float4(o[i][c][0] / l[i], o[i][c][1] / l[i],
                      o[i][c][2] / l[i], o[i][c][3] / l[i]);
    }
  }
}

// attend with NI = ni, the row slots that hold a row of the block's tile.
template <int NI = MI>
__device__ __forceinline__ void attend_rows(int ni, const float* qkv,
                                            const float* mask, float* out,
                                            int T, int H, float scale,
                                            float* smem) {
  if constexpr (NI == 1) {
    attend<1>(qkv, mask, out, T, H, scale, smem);
  } else {
    if (ni == NI) {
      attend<NI>(qkv, mask, out, T, H, scale, smem);
    } else {
      attend_rows<NI - 1>(ni, qkv, mask, out, T, H, scale, smem);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    packed_attention_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ mask,
                            float* __restrict__ out, int T, int H,
                            float scale) {
  extern __shared__ __align__(16) float smem[];
  const int rows = min(BQ, T - static_cast<int>(blockIdx.x) * BQ);
  attend_rows<>((rows + RG - 1) / RG, qkv, mask, out, T, H, scale, smem);
}

}  // namespace

// qkv [B, T, 3 H 128], out [B, T, H 128], both 16-byte aligned; mask
// [T, T] or null; all float32, contiguous, on the device.  Launches on
// `stream` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int packed_attention_f32(const float* qkv, const float* mask,
                                    float* out, int B, int T, int H,
                                    int head_dim, float scale, void* stream) {
  if (B < 1 || B > 65535 || T < 1 || H < 1 || H > 65535 || head_dim != HD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(out)) &
      15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(packed_attention_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  packed_attention_kernel<<<grid, THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      qkv, mask, out, T, H, scale);
  return static_cast<int>(cudaGetLastError());
}
