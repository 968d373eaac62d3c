// Owner-partitioned rounds, shared by K6 (bm25_block_score.cu,
// dense_score_kernel) and K1/K3 (bm25_resident.cu, resident_topk_kernel).
//
// A CTA of 16 warps holds a [rows, 64] f32 accumulator in shared memory,
// two query columns a lane; row r belongs to warp r % 16. Each thread
// brings a round's postings as (row, score bits, weight slot) entries,
// kRoundPer of them, every load of the round already issued. The round
// partitions them stably by owner warp: __match_any_sync gives a
// posting's rank among its warp's lanes of the same owner, one scan of the
// integer counts gives each owner its postings, in posting order, as one
// contiguous list in `stage`. Each warp then adds its own list in order,
// kRoundGroup postings at a time with their loads issued together (a row
// met twice in a group takes the sum so far): one writer an element, in
// posting order, with __fmul_rn then __fadd_rn (no FMA contraction), no
// atomics. A lane keeps its two weights in registers while the list stays
// in one weight slot.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bm25 {

// An element of scores or weights in f32: a float as it is, a bf16
// widened exactly (so the f32 instantiations read what they always read).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int kRoundThreads = 512;
constexpr int kRoundWarps = kRoundThreads / 32;  // row owners: row % 16
constexpr int kRoundCols = 64;      // query columns a CTA, two a lane
constexpr int kRoundStage = 2048;   // postings staged a round
constexpr int kRoundPer = kRoundStage / kRoundThreads;  // a thread's share
constexpr int kRoundRuns = 128;     // runs (weight rows) staged a round
constexpr int kRoundCounts = kRoundWarps * kRoundPer * kRoundWarps;
constexpr int kRoundGroup = 4;      // postings a warp adds together
static_assert(kRoundCounts == 2 * kRoundThreads,
              "the owner scan takes two counts a thread");
constexpr unsigned kRoundFull = 0xffffffffu;

// CTA-wide exclusive scan of one 64-bit value a thread; `total` gets the
// sum. s_tmp holds kRoundWarps values and is free again after return.
__device__ __forceinline__ unsigned long long cta_scan(
    unsigned long long v, unsigned long long* s_tmp,
    unsigned long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(kRoundFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_tmp[warp] = incl;
  __syncthreads();
  unsigned long long before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kRoundWarps; ++w) {
    if (w < warp) before += s_tmp[w];
    total += s_tmp[w];
  }
  __syncthreads();
  return before + incl - v;
}

// One round: add this thread's entries ent[j] = (row, score bits, weight
// slot, 0) into acc ([rows][64], rows outside [0, block_size) are
// skipped). With staged_w a slot indexes the [kRoundRuns][64] weights in
// wst; otherwise it is a row of the global [*, n_cols] table w. `counts`
// ([kRoundCounts]) must be zero on entry and is zero again on return;
// `stage` holds kRoundStage entries, s_scan kRoundWarps values and s_seg
// kRoundWarps + 1. Ends with a barrier: stage, wst and counts are free.
// TW: the global table's element (float, or bf16 read widened to f32).
template <typename TW>
__device__ __forceinline__ void owner_round(
    const int4 (&ent)[kRoundPer], int block_size, bool staged_w,
    const float* wst, const TW* __restrict__ w, int n_cols, int col,
    float* acc, int4* stage, int* counts, unsigned long long* s_scan,
    int* s_seg) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int own[kRoundPer], rank[kRoundPer];
#pragma unroll
  for (int j = 0; j < kRoundPer; ++j)
    own[j] = static_cast<unsigned>(ent[j].x)
                     < static_cast<unsigned>(block_size)
                 ? (ent[j].x & (kRoundWarps - 1)) : -1;
  // stable partition by owner warp: a posting's rank among its warp's
  // lanes of the same owner, and that group's size at counts[(owner, j,
  // warp)]; the counts in that order, scanned once, give each owner its
  // postings in posting order (integer counts: no order is lost)
#pragma unroll
  for (int j = 0; j < kRoundPer; ++j) {
    const unsigned mm = __match_any_sync(kRoundFull, own[j]);
    rank[j] = __popc(mm & lt);
    if (own[j] >= 0 && rank[j] == 0)
      counts[(own[j] * kRoundPer + j) * kRoundWarps + warp] = __popc(mm);
  }
  __syncthreads();
  const int c0 = counts[2 * tid], c1 = counts[2 * tid + 1];
  unsigned long long n_staged;
  const int off = static_cast<int>(cta_scan(c0 + c1, s_scan, n_staged));
  counts[2 * tid] = off;
  counts[2 * tid + 1] = off + c0;
  if (lane == 0) s_seg[warp] = off;   // owner `warp`'s first entry
  if (tid == 0) s_seg[kRoundWarps] = static_cast<int>(n_staged);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRoundPer; ++j) {
    if (own[j] >= 0)
      stage[counts[(own[j] * kRoundPer + j) * kRoundWarps + warp]
            + rank[j]] = ent[j];
  }
  __syncthreads();

  // my rows' postings, in posting order, kRoundGroup at a time: their
  // loads issued together, a row met twice in a group taken in order
  const float2* wst2 = reinterpret_cast<const float2*>(wst);
  float2* acc2 = reinterpret_cast<float2*>(acc);
  int cur = -1;                                   // weights held for
  float2 wc = make_float2(0.f, 0.f);
  for (int i = tid; i < kRoundCounts; i += kRoundThreads) counts[i] = 0;
  const int end = s_seg[warp + 1];        // counts is free: s_seg holds
  for (int k = s_seg[warp]; k < end; k += kRoundGroup) {
    int4 e[kRoundGroup];
    float2 wv[kRoundGroup], av[kRoundGroup];
#pragma unroll
    for (int g = 0; g < kRoundGroup; ++g)
      e[g] = k + g < end ? stage[k + g] : make_int4(-1, 0, 0, 0);
#pragma unroll
    for (int g = 0; g < kRoundGroup; ++g) {
      // a pad past the list (row -1) loads no weights: a stale slot
      // there would read w[-n_cols] on the global path
      if (e[g].x >= 0 && e[g].z != cur) {
        cur = e[g].z;
        if (staged_w) {
          wc = wst2[cur * (kRoundCols / 2) + lane];
        } else {
          const TW* wr = w + static_cast<size_t>(cur) * n_cols;
          wc.x = col < n_cols ? to_f32(wr[col]) : 0.f;
          wc.y = col + 1 < n_cols ? to_f32(wr[col + 1]) : 0.f;
        }
      }
      wv[g] = wc;
      av[g] = e[g].x >= 0 ? acc2[e[g].x * (kRoundCols / 2) + lane]
                          : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int g = 0; g < kRoundGroup; ++g) {
#pragma unroll
      for (int h = 0; h < g; ++h)
        if (e[h].x == e[g].x) av[g] = av[h];      // the sum so far
      const float s = __int_as_float(e[g].y);
      av[g].x = __fadd_rn(av[g].x, __fmul_rn(s, wv[g].x));
      av[g].y = __fadd_rn(av[g].y, __fmul_rn(s, wv[g].y));
    }
#pragma unroll
    for (int g = 0; g < kRoundGroup; ++g)
      if (e[g].x >= 0) acc2[e[g].x * (kRoundCols / 2) + lane] = av[g];
  }
  __syncthreads();                 // stage, wst and counts are free
}

}  // namespace bm25
