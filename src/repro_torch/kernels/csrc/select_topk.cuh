// Column-wise top-k selection shared by the BM25 kernels of the port.
//
// Replaces: src/repro/kernels/blockwise_topk.py::select_topk (k rounds of
// max / argmax / mask over a VMEM accumulator) and the winner fold of
// src/repro/kernels/bm25_gather_score.py::_fold_winners.
//
// On the TPU one grid step owns the whole [rows, B] accumulator and the
// sequential grid orders equal scores by schedule. Here a warp owns one
// query column: each lane scans a strided slice of the column held in
// shared memory, a butterfly of shuffles picks the warp-wide winner, and
// the winning lane marks its entry taken (-INF, below the padding value
// -FLT_MAX, so padding is still selected before anything taken). Every
// comparison follows one total order — score descending, then document id
// ascending, then position — so the result does not depend on which warp,
// CTA or launch saw an entry first, and the plain torch twin reproduces it
// with one sort (repro_torch.core.retrieval.rank_order).
//
// Bound: k rounds over `rows` entries per column, all in shared memory;
// small next to the scoring loops that fill the accumulator.
#pragma once

#include <cfloat>
#include <climits>
#include <cstddef>
#include <cuda_runtime.h>

namespace bm25 {

// (v1, g1) ranks before (v2, g2): score descending, then id ascending.
__device__ __forceinline__ bool rank_before(float v1, int g1, float v2,
                                            int g2) {
  return v1 > v2 || (v1 == v2 && g1 < g2);
}

// Warp-wide best (v, g); exact ties on (v, g) go to the lower position p.
// All 32 lanes must call it; all return the same winner.
__device__ __forceinline__ void warp_best(float& v, int& g, int& p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int og = __shfl_xor_sync(0xffffffffu, g, off);
    const int op = __shfl_xor_sync(0xffffffffu, p, off);
    if (rank_before(ov, og, v, g) || (ov == v && og == g && op < p)) {
      v = ov;
      g = og;
      p = op;
    }
  }
}

// Best entry of a strided shared-memory column col[r * ld], r < n, whose
// id is id_of(r). Taken entries hold -INF. The caller guarantees at least
// one untaken entry, so the winner is always a real position.
template <typename IdOf>
__device__ __forceinline__ void column_best(const float* col, int ld, int n,
                                            IdOf id_of, int lane, float& v,
                                            int& g, int& p) {
  v = -INFINITY;
  g = INT_MAX;
  p = INT_MAX;
  for (int r = lane; r < n; r += 32) {
    const float x = col[static_cast<size_t>(r) * ld];
    const int id = id_of(r);
    if (rank_before(x, id, v, g)) {
      v = x;
      g = id;
      p = r;
    }
  }
  warp_best(v, g, p);
}

// Mark position p of the column taken; the lane that scans p does it, so
// the next round's read of p is ordered after the write in that thread.
__device__ __forceinline__ void column_take(float* col, int ld, int p,
                                            int lane) {
  if (lane == (p & 31)) col[static_cast<size_t>(p) * ld] = -INFINITY;
}

}  // namespace bm25
