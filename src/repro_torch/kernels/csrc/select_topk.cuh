// The port's total order on (score, id) entries, shared by the BM25
// kernels: score descending, then id ascending (rank_before), and the
// warp-wide best entry under it (warp_best, used by board_merge.cuh).
//
// Replaces: src/repro/kernels/blockwise_topk.py::select_topk's order (k
// rounds of max / argmax / mask over a VMEM accumulator) and the winner
// fold of src/repro/kernels/bm25_gather_score.py::_fold_winners.
//
// On the TPU one grid step owns the whole [rows, B] accumulator and the
// sequential grid orders equal scores by schedule. Here every comparison
// follows one total order, so the result does not depend on which warp,
// CTA or launch saw an entry first, and the plain torch twin reproduces it
// with one sort (repro_torch.core.retrieval.rank_order). The selection
// itself is threshold_fold.cuh's (K1-K4) and board_merge.cuh's merge of
// sorted boards.
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

}  // namespace bm25
