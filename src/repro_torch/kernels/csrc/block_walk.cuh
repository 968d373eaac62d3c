// The walk of one block of block-bucketed postings into a [rows, 64]
// shared accumulator, shared by K6 (bm25_block_score.cu,
// dense_score_kernel) and K2/K4 (block_topk.cuh: a document block of the
// full scan, or a chunk of host-gathered candidates).
//
// What it adds, for the CTA's 64 query columns col0 .. col0 + 63 (two a
// lane): acc[r, c] += fl(sc[p] * w[u, col0 + c]) for every posting p of
// the block, in posting order, whose token is row u of the batch's sorted
// unique table and whose row loc[p] - row0 lies in [0, rows). A caller
// with more than `rows` block rows walks them in windows, one call each.
//
// * The CTA first reads its block's tokens once, to see whether they
//   ascend with the -1 pads at the end (block_postings_from_coo's layout,
//   which the blocked index and the host gather both build). Then the
//   batch's sorted table names the matched postings as runs: one search
//   of each uniq[u] in the block's tokens (U searches, not one a posting;
//   a shared sample of every stride-th token narrows each to a few global
//   reads), and only matched postings are read. The runs come in table
//   order, which is posting order. The table is searched kWalkTable rows a
//   piece, and each piece's runs are added before the next piece is
//   searched, so the run table's shared memory does not grow with U: the
//   walk takes any U. A block whose tokens do not ascend is still summed
//   right: it takes a slower path that searches each posting's token in
//   the table and reads its weight row from global memory.
// * Rounds of kRoundStage postings (and the weight rows of at most
//   kRoundRuns runs) are loaded with every load of the round in flight at
//   once, then owner_round.cuh partitions them stably by owner warp and
//   each warp adds its own rows' list in posting order: one writer an
//   element, __fmul_rn then __fadd_rn, no atomics.
#pragma once

#include "owner_round.cuh"

namespace bm25 {

constexpr int kWalkTable = 2048;   // table rows searched a piece
static_assert(2 * kWalkTable <= 4 * kRoundStage,
              "a piece's search scratch (2 ints a row) fits the stage");
static_assert((kRoundRuns & (kRoundRuns - 1)) == 0
                  && kRoundRuns * kRoundCols % kRoundThreads == 0,
              "the run search steps by powers of two; whole weight rounds");

// Shared memory of the walk besides the accumulator, in bytes: the staged
// postings, weight rows and owner counts, and one piece's run table.
constexpr long long kWalkScratchBytes =
    kRoundStage * 16LL + kRoundRuns * kRoundCols * 4LL + kRoundCounts * 4LL
    + (3LL * kWalkTable + 1) * 4;

// The walk's shared memory, carved from the CTA's dynamic shared memory
// after an accumulator of acc_rows rows (see walk_carve).
struct WalkSmem {
  float* acc;                 // [acc_rows][64]
  int4* stage;                // [kRoundStage]
  float* wst;                 // [kRoundRuns][64]
  int* counts;                // [kRoundCounts], zero between rounds
  int* run_u;                 // [kWalkTable]
  int* run_lo;                // [kWalkTable]
  int* run_off;               // [kWalkTable + 1]
  unsigned long long* s_scan; // [kRoundWarps], static shared memory
  int* s_seg;                 // [kRoundWarps + 1], static shared memory
  unsigned char* end;         // first byte past the run table
};

__device__ __forceinline__ WalkSmem walk_carve(unsigned char* smem,
                                               int acc_rows,
                                               unsigned long long* s_scan,
                                               int* s_seg) {
  WalkSmem s;
  s.acc = reinterpret_cast<float*>(smem);
  s.stage = reinterpret_cast<int4*>(
      s.acc + static_cast<size_t>(acc_rows) * kRoundCols);
  s.wst = reinterpret_cast<float*>(s.stage + kRoundStage);
  s.counts = reinterpret_cast<int*>(s.wst + kRoundRuns * kRoundCols);
  s.run_u = s.counts + kRoundCounts;
  s.run_lo = s.run_u + kWalkTable;
  s.run_off = s.run_lo + kWalkTable;
  s.s_scan = s_scan;
  s.s_seg = s_seg;
  s.end = reinterpret_cast<unsigned char*>(s.run_off + kWalkTable + 1);
  return s;
}

// First index in [0, n) whose value is >= t (or > t with kUpper), over an
// ascending array.
template <bool kUpper>
__device__ __forceinline__ int search(const int* __restrict__ a, int n,
                                      int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kUpper ? a[mid] <= t : a[mid] < t) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// search<kUpper> over tb[0, n), narrowed first by samp[j] = tb[j * stride]
// (n_samp samples, in shared memory): a few global steps, not log2(n).
template <bool kUpper>
__device__ __forceinline__ int search_sampled(const int* __restrict__ tb,
                                              int n, const int* samp,
                                              int n_samp, int stride, int t) {
  const int js = search<kUpper>(samp, n_samp, t);
  const int a = js > 0 ? (js - 1) * stride + 1 : 0;
  const int b = min(js * stride, n);
  return a + search<kUpper>(tb + a, b - a, t);
}

// Do the block's real tokens tb[0, p_pad) ascend, -1 pads after them?
// n_real gets the number of real (>= 0) tokens. Four consecutive tokens a
// thread, their loads in flight together. Called by the whole CTA; ends
// with a barrier.
__device__ __forceinline__ bool tokens_ascend(const int* __restrict__ tb,
                                              int p_pad,
                                              unsigned long long* s_scan,
                                              int& n_real) {
  const int tid = threadIdx.x;
  unsigned long long real = 0;
  bool bad = false;
#pragma unroll 4
  for (int p0 = 4 * tid; p0 < p_pad; p0 += 4 * kRoundThreads) {
    int v[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) v[j] = p0 + j < p_pad ? tb[p0 + j] : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      real += v[j] >= 0 && p0 + j < p_pad;
      bad |= v[j + 1] >= 0 && (v[j] < 0 || v[j + 1] < v[j]);
    }
  }
  const bool sorted = !__syncthreads_or(bad);
  unsigned long long n_real_ll;
  cta_scan(real, s_scan, n_real_ll);
  n_real = static_cast<int>(n_real_ll);
  return sorted;
}

// Add the block's postings (tb, lb, sb: p_pad of them, n_real real, in
// ascending token order when `sorted`) whose row lb[p] - row0 lies in
// [0, rows) into s.acc, for the query columns col0 + 2 lane, col0 + 2 lane
// + 1. s.counts must be zero on entry (it is again on return). Called by
// the whole CTA; the accumulator is complete after the caller's next
// barrier. TS, TW: the scores' and the weights' element (float, or bf16:
// each is widened exactly to f32 as it is read, and the products and sums
// are the f32 walk's).
template <typename TS, typename TW>
__device__ __forceinline__ void walk_block(
    const int* __restrict__ tb, const int* __restrict__ lb,
    const TS* __restrict__ sb, int p_pad, int n_real, bool sorted,
    const int* __restrict__ uniq, int n_uniq, const TW* __restrict__ w,
    int n_cols, int col0, int row0, int rows, const WalkSmem& s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  int* const run_u = s.run_u;
  int* const run_lo = s.run_lo;
  int* const run_off = s.run_off;
  // sorted: the matched postings as runs, one a table row, in table order,
  // the table taken kWalkTable rows a piece (a later piece's runs follow
  // an earlier one's in posting order); any other order: one piece
  const int stride = max(1, (n_real + kRoundRuns * kRoundCols - 1)
                                / (kRoundRuns * kRoundCols));
  const int n_samp = (n_real + stride - 1) / stride;
  const int n_pieces =
      sorted ? max(1, (n_uniq + kWalkTable - 1) / kWalkTable) : 1;
  const int col = col0 + 2 * lane;                  // my two columns
  for (int piece = 0; piece < n_pieces; ++piece) {
    const int u0 = piece * kWalkTable;
    const int n_piece = min(kWalkTable, n_uniq - u0);
    int n_runs = 0, n_matched = 0;
    if (sorted) {
      int* t_lo = reinterpret_cast<int*>(s.stage);    // scratch [kWalkTable]
      int* t_len = t_lo + kWalkTable;                 // scratch [kWalkTable]
      int* samp = reinterpret_cast<int*>(s.wst);      // scratch samples
      for (int j = tid; j < n_samp; j += kRoundThreads)
        samp[j] = tb[j * stride];
      __syncthreads();
      for (int v = tid; v < n_piece; v += kRoundThreads) {
        const int u = u0 + v;
        const int t = uniq[u];
        int lo = 0, len = 0;
        // a repeated table row matches nothing (the twin's searchsorted
        // takes the first); negative tokens are padding
        if (t >= 0 && (u == 0 || uniq[u - 1] != t)) {
          lo = search_sampled<false>(tb, n_real, samp, n_samp, stride, t);
          if (lo < n_real && tb[lo] == t)
            len = search_sampled<true>(tb, n_real, samp, n_samp, stride, t)
                  - lo;
        }
        t_lo[v] = lo;
        t_len[v] = len;
      }
      __syncthreads();
      // compact the non-empty runs: thread t takes piece rows [g0, g1)
      const int g = (n_piece + kRoundThreads - 1) / kRoundThreads;
      const int g0 = min(tid * g, n_piece), g1 = min(g0 + g, n_piece);
      unsigned long long mine = 0;                    // runs << 32 | postings
      for (int v = g0; v < g1; ++v)
        if (t_len[v] > 0) mine += (1ull << 32) + t_len[v];
      unsigned long long total;
      const unsigned long long at = cta_scan(mine, s.s_scan, total);
      n_runs = static_cast<int>(total >> 32);
      n_matched = static_cast<int>(total & 0xffffffffu);
      int r = static_cast<int>(at >> 32), m = static_cast<int>(at);
      for (int v = g0; v < g1; ++v) {
        if (t_len[v] == 0) continue;
        run_u[r] = u0 + v;
        run_lo[r] = t_lo[v];
        run_off[r] = m;
        m += t_len[v];
        ++r;
      }
      if (tid == 0) run_off[n_runs] = n_matched;
      __syncthreads();
    }

    // rounds of at most kRoundStage postings: matched runs (sorted), or
    // every posting with its token searched in the table (any other order)
    const int n_total = sorted ? n_matched : p_pad;
    int r0 = 0;                                       // run holding m0
    for (int m0 = 0; m0 < n_total;) {
      int m1;
      // this thread's postings m0 + tid + j * 512 and weights: every load
      // of the round issued before the first one is used
      constexpr int kW = kRoundRuns * kRoundCols / kRoundThreads;
      int pos[kRoundPer], slot[kRoundPer];
      float wreg[kW];
      int r_end = 0;
      if (sorted) {
        r_end = min(r0 + kRoundRuns, n_runs);
        m1 = min(m0 + kRoundStage, run_off[r_end]);
#pragma unroll
        for (int j = 0; j < kW; ++j) {          // the runs' weight rows
          const int i = tid + j * kRoundThreads;
          const int c = col0 + (i % kRoundCols);
          wreg[j] = r0 + i / kRoundCols < r_end && c < n_cols
                        ? to_f32(w[static_cast<size_t>(
                                       run_u[r0 + i / kRoundCols])
                                   * n_cols + c])
                        : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kRoundPer; ++j) {
          const int m = m0 + tid + j * kRoundThreads;
          int lo = r0;            // the last run starting <= m, in a
#pragma unroll                          // fixed number of steps
          for (int step = kRoundRuns / 2; step > 0; step >>= 1)
            if (lo + step < r_end && run_off[lo + step] <= m) lo += step;
          pos[j] = m < m1 ? run_lo[lo] + (m - run_off[lo]) : -1;
          slot[j] = lo - r0;
        }
      } else {
        m1 = min(m0 + kRoundStage, p_pad);
#pragma unroll
        for (int j = 0; j < kRoundPer; ++j) {
          const int p = m0 + tid + j * kRoundThreads;
          const int t = p < m1 ? tb[p] : -1;
          int u = -1;
          if (t >= 0) {
            u = search<false>(uniq, n_uniq, t);
            if (u == n_uniq || uniq[u] != t) u = -1;
          }
          pos[j] = u >= 0 ? p : -1;
          slot[j] = u;
        }
      }
      int4 ent[kRoundPer];
#pragma unroll
      for (int j = 0; j < kRoundPer; ++j)
        ent[j] = pos[j] >= 0
                     ? make_int4(lb[pos[j]] - row0,
                                 __float_as_int(to_f32(sb[pos[j]])),
                                 slot[j], 0)
                     : make_int4(-1, 0, slot[j], 0);
      if (sorted) {
#pragma unroll
        for (int j = 0; j < kW; ++j)
          s.wst[tid + j * kRoundThreads] = wreg[j];
      }
      owner_round(ent, rows, sorted, s.wst, w, n_cols, col, s.acc, s.stage,
                  s.counts, s.s_scan, s.s_seg);
      m0 = m1;
      if (sorted && m0 < n_matched) {                 // the run holding m0
        int lo = r0, hi = n_runs - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (run_off[mid] <= m0) lo = mid; else hi = mid - 1;
        }
        r0 = lo;
      }
    }
  }
}

}  // namespace bm25
