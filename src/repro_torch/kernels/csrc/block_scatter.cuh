// Scatter of one block's token-sorted postings into a [rows, 32] shared
// accumulator, shared by K2 (a document block of the full scan) and K4 (a
// chunk of host-gathered candidates).
//
// Replaces: src/repro/kernels/bm25_block_score.py::_score_tile, the
// membership test and one-hot scatter both TPU kernels score with.
//
// What it computes, for the CTA's 32 query columns col_base + lane:
//   acc[row * kScatterLd + lane] += fl(sc[p] * w[u, col]) for every posting
//   p < p_pad, in posting order, whose token tok[p] sits at row u of the
//   sorted unique table uniq_s and whose row loc[p] is in [0, rows).
//
// Postings within a block are token-sorted and several hit the same row,
// so threads over postings would collide. A chunk of 256 postings is read
// one a thread; each thread binary-searches its posting's token in the
// shared unique table, and the matched postings are staged in shared
// memory partitioned by owning warp (warp w owns rows r with r % 8 == w),
// stably, with ballots. Each warp then walks only its own entries in
// posting order, a lane per query column. Each accumulator element has
// exactly one writer and a fixed summation order: no atomics. Products and
// sums are __fmul_rn then __fadd_rn: nvcc would otherwise contract
// acc + s * w into one FMA, which rounds once where the twins round twice.
#pragma once

#include <cuda_runtime.h>

namespace bm25 {

constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / 32;  // row owners (8)
constexpr int kScatterCols = 32;       // query columns a CTA (a lane each)
constexpr int kScatterLd = kScatterCols + 1;  // a column's rows fall in
                                              // distinct shared banks
constexpr int kScatterChunk = kScatterThreads;  // postings read a round

// Shared staging the scatter needs besides the accumulator, in bytes.
constexpr int kScatterStagingBytes = 3 * kScatterChunk * 4;

// Called by all kScatterThreads threads of the CTA. `tok`, `loc`, `sc`
// point at the block's p_pad postings; `acc` ([rows * kScatterLd], zeroed)
// and `uniq_s` ([n_uniq], sorted) are in shared memory, as is `staging`
// (kScatterStagingBytes). Columns col_base + lane >= n_cols are skipped.
__device__ __forceinline__ void scatter_block_postings(
    const int* __restrict__ tok, const int* __restrict__ loc,
    const float* __restrict__ sc, int p_pad, const int* uniq_s, int n_uniq,
    const float* __restrict__ w, int n_cols, int col_base, int rows,
    float* acc, unsigned char* staging) {
  int* e_row = reinterpret_cast<int*>(staging);          // [kScatterChunk]
  int* e_loc = e_row + kScatterChunk;                    // [kScatterChunk]
  float* e_sc = reinterpret_cast<float*>(e_loc + kScatterChunk);
  // matched counts and staging offsets, [owner * kScatterWarps + warp]
  __shared__ int s_cnt[kScatterWarps * kScatterWarps];
  __shared__ int s_off[kScatterWarps * kScatterWarps];
  __shared__ int s_end[kScatterWarps];   // end of each owner's entries

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = col_base + lane;

  for (int base = 0; base < p_pad; base += kScatterChunk) {
    const int p = base + tid;
    int t = -1, l = 0, r = -1;
    float s = 0.f;
    if (p < p_pad) {
      t = tok[p];
      l = loc[p];
      s = sc[p];
    }
    if (t >= 0 && static_cast<unsigned>(l) < static_cast<unsigned>(rows)) {
      int lo = 0, hi = n_uniq;  // lower bound of t in the sorted table
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (uniq_s[mid] < t) lo = mid + 1; else hi = mid;
      }
      if (lo < n_uniq && uniq_s[lo] == t) r = lo;
    }
    // stable partition of the matched postings by owner warp (l % 8)
    const int owner = r >= 0 ? (l & (kScatterWarps - 1)) : -1;
    int rank = 0;
#pragma unroll
    for (int q = 0; q < kScatterWarps; ++q) {
      const unsigned m = __ballot_sync(0xffffffffu, owner == q);
      if (lane == 0) s_cnt[q * kScatterWarps + warp] = __popc(m);
      if (owner == q) rank = __popc(m & ((1u << lane) - 1u));
    }
    if (!__syncthreads_or(owner >= 0)) continue;  // nothing matched
    if (warp == 0) {  // exclusive scan of the 64 counts, two a lane
      const int c0 = s_cnt[2 * lane], c1 = s_cnt[2 * lane + 1];
      int x = c0 + c1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      s_off[2 * lane] = x - c0 - c1;
      s_off[2 * lane + 1] = x - c1;
      if ((lane & 3) == 3) s_end[lane >> 2] = x;  // owner lane/4 ends here
    }
    __syncthreads();
    if (owner >= 0) {
      const int e = s_off[owner * kScatterWarps + warp] + rank;
      e_row[e] = r;
      e_loc[e] = l;
      e_sc[e] = s;
    }
    __syncthreads();
    if (col < n_cols) {
      const int e1 = s_end[warp];
#pragma unroll 4
      for (int e = warp == 0 ? 0 : s_end[warp - 1]; e < e1; ++e) {
        const float prod = __fmul_rn(
            e_sc[e], w[static_cast<size_t>(e_row[e]) * n_cols + col]);
        float* a = acc + static_cast<size_t>(e_loc[e]) * kScatterLd + lane;
        *a = __fadd_rn(*a, prod);
      }
    }
    __syncthreads();
  }
}

}  // namespace bm25
