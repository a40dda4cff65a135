// The ball query's walk of K6 (sa.cu).  K1 (ball_group.cu) selects the same
// slots from hit words read by whole warps; chip_smoke.py holds the two
// against each other bit for bit.
//
// One thread walks the candidates of one query in index order over its
// column of the transposed distances d2t [B, N, M] (`col` points at
// d2t[b, 0, m], the next candidate lies M floats on) and calls
// on_hit(slot, n) for the first S candidates with d2t < r2, slot counting
// from 0.  Returns the number of hits, at most S; the walk stops at the S-th.
// The threads of a warp sit on neighbouring m, so each step reads 32
// consecutive floats of a d2t row (coalesced).

#pragma once

template <typename OnHit>
__device__ __forceinline__ int ball_walk(const float* __restrict__ col, int N,
                                         int M, int S, float r2,
                                         OnHit on_hit) {
  int hits = 0;
  for (int n = 0; n < N && hits < S; ++n) {
    if (col[(size_t)n * M] < r2) {
      on_hit(hits, n);
      ++hits;
    }
  }
  return hits;
}
