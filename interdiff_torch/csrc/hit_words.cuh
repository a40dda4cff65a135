// The ball query's walk and selection in hit words, shared by K1
// (ball_group.cu) and K6 (sa.cu), so the two select the same slots by the
// same code.
//
// A block owns HIT_QUERIES = 32 neighbouring queries of one cloud, one per
// lane, and WARPS warps.  Distances come transposed, d2t [B, N, M]: `col`
// points at d2t[b, 0, m0 + lane] and the next candidate lies `stride` (M)
// floats on, so a warp reading one candidate row reads 32 consecutive
// floats (one 128-byte segment).
//
// 1. hit_word_walk, called by every thread of the block: in each round of
//    WARPS * 32 candidates warp w reads candidates [round * WARPS * 32 +
//    32w, +32), LOADS loads issued back to back and independent of one
//    another, and each lane folds its query's 32 comparisons d2t < r2 into
//    one 32-bit word (bit i: candidate 32k + i of word k).  The words go to
//    shared memory as [word][query], rows padded to HIT_PITCH = 33 so that
//    the store (a warp on one word) and the selection's load (a warp on one
//    query) are free of bank conflicts.  After each round every lane adds
//    up its query's popcounts over the round's words, and the block stops
//    once each of its live queries holds S hits (__syncthreads_and): the
//    early exit of the walk, at the granularity of 32 queries.  Returns the
//    rounds read.
// 2. select_hits, called by one warp for one query: lane l holds words l,
//    l+32, ...; a warp prefix sum of their popcounts gives each word's first
//    rank, and each lane writes the candidate of every hit of rank below S
//    (lowest bit first) to list[rank].  Returns min(hits, S); the list is
//    visible to the whole warp on return.
// The slot that a candidate takes is its rank among the in-radius
// candidates in index order, as in the plain version: the walk only reads
// in parallel what the plain version reads in order.

#pragma once

constexpr int HIT_QUERIES = 32;            // queries a block, one per lane
constexpr int HIT_PITCH = HIT_QUERIES + 1;  // shared row of one hit word

template <int WARPS, int LOADS>
__device__ __forceinline__ int hit_word_walk(const float* __restrict__ col,
                                             int N, size_t stride, int S,
                                             float r2, bool live,
                                             unsigned* words, int n_rounds) {
  constexpr int ROUND = WARPS * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int hits = 0;  // of query `lane`, in the rounds read so far
  int rounds = 0;
  while (rounds < n_rounds) {
    const int n0 = rounds * ROUND + warp * 32;
    unsigned word = 0u;
    if (live) {
#pragma unroll
      for (int h = 0; h < 32; h += LOADS) {
        float v[LOADS];
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          const int n = n0 + h + i;
          v[i] = n < N ? col[(size_t)n * stride] : r2;  // r2: not a hit
        }
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          word |= static_cast<unsigned>(v[i] < r2) << (h + i);
        }
      }
    }
    unsigned* round_words = words + rounds * WARPS * HIT_PITCH;
    round_words[warp * HIT_PITCH + lane] = word;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      hits += __popc(round_words[w * HIT_PITCH + lane]);
    }
    ++rounds;
    if (__syncthreads_and(!live || hits >= S)) break;
  }
  return rounds;
}

__device__ __forceinline__ int select_hits(const unsigned* words, int n_words,
                                           int q, int S, int* list) {
  const int lane = threadIdx.x & 31;
  int run = 0;  // hits in the words before this chunk of 32
  for (int base = 0; base < n_words && run < S; base += 32) {
    const int k = base + lane;
    unsigned word = k < n_words ? words[k * HIT_PITCH + q] : 0u;
    const int pc = __popc(word);
    int inc = pc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(~0u, inc, o);
      if (lane >= o) inc += t;
    }
    for (int rank = run + inc - pc; word != 0u && rank < S; ++rank) {
      list[rank] = k * 32 + __ffs(word) - 1;
      word &= word - 1u;
    }
    run += __shfl_sync(~0u, inc, 31);
  }
  __syncwarp();
  return min(run, S);
}
