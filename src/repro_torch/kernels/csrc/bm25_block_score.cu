// K2: fused full-scan score -> per-block top-k over block-bucketed postings,
// and K6: the same scan's dense per-block scores (a kernel of its own).
//
// Replaces: src/repro/kernels/bm25_block_score.py::bm25_block_score_topk
// (_fused_kernel, _score_tile; pallas_call at bm25_block_score.py:206) and
// src/repro/kernels/bm25_block_score.py::bm25_block_score (_kernel,
// _score_tile; pallas_call at bm25_block_score.py:163).
//
// What it computes, per document block i and query column b:
//   acc[d, b] = sum over postings p of block i, in posting order, whose
//               token is in the batch's sorted unique table at row u, of
//               fl(score[p] * w[u, b]) into row d = local_doc[p];
//   rows whose global doc id is >= n_docs are set to -FLT_MAX;
//   out[i, r, b] = the r-th entry of the column in (score desc, row asc)
//               order, with its block-local row.
//
// Bound on the H100: every (matched posting, query column) pair costs one
// FP32 multiply and one FP32 add on the CUDA cores (2 operations against
// the card's 67 TFLOP/s), and every posting tile is read once (12 bytes a
// posting against 3.35 TB/s). For a dense batch the adds dominate; the
// shared-memory read-modify-write of the accumulator is the practical
// limit of this first version.
//
// Design:
// * The TPU keeps the whole [block_size, B] accumulator in VMEM. At block
//   512 and B = 256 that is 512 KB, over a CTA's 227 KB of shared memory,
//   so the grid is (B-tile, block): each CTA holds [block_size, 32] for
//   32 query columns (66 KB at 512 x 32, rows padded to 33 words so the
//   column-wise selection reads distinct banks). The B-tiles of one block
//   are adjacent in launch order, so they share its posting tiles in L2.
// * The scatter is block_scatter.cuh (shared with K4): matched postings
//   are staged by owning warp with ballots, so each accumulator element has
//   one writer and sums in posting order, with __fmul_rn / __fadd_rn — no
//   atomics, bitwise equal to the twin.
// * Selection is the shared select_topk.cuh (a warp per column).
//
// K6 computes K2's sums without the padding mask and the selection, as
// the reference's _kernel has neither (ops.bm25_score_blocked slices the
// padded documents off): out[i, d, b] = acc[d, b] of block i, for every
// row d < block_size. Bound on the H100: the posting reads (12 bytes a
// posting) plus the dense output, nb * block_size * B floats written once,
// against 3.35 TB/s; at full width ([4,096, 512, 256], 2.15 GB written)
// the write is most of the 1.543 ms. The (matched posting, column)
// products and sums are 2 FP32 operations each, under the bytes.
//
// What K6's first version (K2's scatter) lost, 50.9 ms at full
// width: each of a block's 8 B-tile CTAs re-read all of its postings and
// binary-searched every posting's token in the unique table; every 256
// postings cost three CTA barriers; and the owner walk read w[u, col] from
// global memory for every matched posting, in a loop whose shared
// read-modify-write chain limits overlap, at 2 CTAs an SM.
//
// K6's design (dense_score_kernel), one CTA of 16 warps a (block, 64
// query columns), two columns a lane, the [block_size, 64] f32
// accumulator in shared memory (128 KB at 512 rows, one CTA an SM):
// * The columns are shared: 64 a CTA, so 4 CTAs a block at B = 256 read
//   and match its postings, not 8.
// * The CTA first reads its block's tokens once, to see whether they
//   ascend with the -1 pads at the end (block_postings_from_coo's layout,
//   the only one the port builds). Then the batch's sorted table names
//   the matched postings as runs: one search of each uniq[u] in the
//   block's tokens (U searches, not one a posting; a shared sample of
//   every stride-th token narrows each to a few global reads), and only
//   matched postings are read (Sigma df / nnz ~ 0.36 of them on phase 6's
//   batch). The runs come in table order, which is posting order. The
//   table is searched 2,048 rows a piece, and each piece's runs are added
//   before the next piece is searched, so the run table's shared memory
//   does not grow with U (one piece at phase 6's U; 4 at 256 x Q_MAX). A block
//   whose tokens do not ascend is still summed right: it takes a slower
//   path that searches each posting's token in the table and reads its
//   weight row from global memory.
// * Rounds of 2,048 postings (and the weight rows of at most 128 runs)
//   are loaded with every load of the round in flight at once, then
//   partitioned stably by owner warp (row % 16): __match_any_sync gives a
//   posting's rank among its warp's lanes of the same owner, one scan of
//   the integer counts gives each owner its postings, in posting order,
//   as one contiguous list. Six barriers a round of 2,048 postings,
//   against three every 256 postings before. The partition and the walk
//   below are owner_round.cuh, shared with K1/K3.
// * Each warp adds its own list in order, 4 postings at a time with their
//   loads issued together (a row met twice in a group takes the sum so
//   far): one writer an element, in posting order, with __fmul_rn then
//   __fadd_rn (no FMA contraction), no atomics: bitwise the twin's
//   block_accumulate. A lane keeps its two weights in registers while
//   the list stays in one run.
// * What is left is shared-memory traffic: a (posting, column) pair reads
//   and writes its accumulator (8 bytes) and mostly reads its weight (4
//   bytes), about 9.4 ms at full width at 128 bytes a cycle an SM (an
//   estimate, not a measurement), and the rounds' loads, partitions and
//   barriers.
// * After the walk each warp writes its own rows, a lane per column:
//   out[blk, row, col0 .. col0 + 31] is 128 contiguous bytes, one
//   coalesced store per row and half.

#include "block_scatter.cuh"
#include "owner_round.cuh"
#include "select_topk.cuh"

namespace {

constexpr int kThreads = bm25::kScatterThreads;
constexpr int kWarps = bm25::kScatterWarps;
constexpr int kCols = bm25::kScatterCols;
constexpr int kLd = bm25::kScatterLd;

__global__ void __launch_bounds__(kThreads) block_score_topk_kernel(
    const int* __restrict__ tok, const int* __restrict__ loc,
    const float* __restrict__ sc, int p_pad, const int* __restrict__ uniq,
    int n_uniq, const float* __restrict__ w, int n_cols, int block_size,
    int k, long long n_docs, float* __restrict__ out_v,
    int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [block_size * kLd]
  int* uniq_s = reinterpret_cast<int*>(
      acc + static_cast<size_t>(block_size) * kLd);     // [n_uniq]
  unsigned char* staging = reinterpret_cast<unsigned char*>(uniq_s + n_uniq);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long blk = blockIdx.y;

  for (int i = tid; i < block_size * kLd; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < n_uniq; i += kThreads) uniq_s[i] = uniq[i];
  __syncthreads();

  const size_t row_base = static_cast<size_t>(blk) * p_pad;
  bm25::scatter_block_postings(tok + row_base, loc + row_base,
                               sc + row_base, p_pad, uniq_s, n_uniq, w,
                               n_cols, blockIdx.x * kCols, block_size, acc,
                               staging);

  // documents past n_docs exist only as block padding: a padded doc's 0.0
  // would outrank real negative scores (robertson IDF), so mask first
  for (int i = tid; i < block_size * kLd; i += kThreads) {
    if (blk * block_size + i / kLd >= n_docs) acc[i] = -FLT_MAX;
  }
  __syncthreads();

  for (int cc = warp; cc < kCols; cc += kWarps) {
    const int gcol = blockIdx.x * kCols + cc;
    if (gcol >= n_cols) continue;  // warp-uniform
    float* colp = acc + cc;
    for (int r = 0; r < k; ++r) {
      float v;
      int g, pos;
      bm25::column_best(colp, kLd, block_size,
                        [](int row) { return row; }, lane, v, g, pos);
      bm25::column_take(colp, kLd, pos, lane);
      if (lane == 0) {
        const size_t o = (static_cast<size_t>(blk) * k + r) * n_cols + gcol;
        out_v[o] = v;
        out_i[o] = g;
      }
      __syncwarp();
    }
  }
}

// -- K6 ------------------------------------------------------------------

constexpr int kDenseThreads = bm25::kRoundThreads;
constexpr int kDenseWarps = bm25::kRoundWarps;   // row owners: row % 16
constexpr int kDenseCols = bm25::kRoundCols;     // query columns a CTA
constexpr int kDenseStage = bm25::kRoundStage;   // postings staged a round
constexpr int kDensePer = bm25::kRoundPer;       // a thread's share
constexpr int kDenseRuns = bm25::kRoundRuns;     // runs staged a round
constexpr int kDenseCounts = bm25::kRoundCounts;
constexpr int kDenseTable = 2048;  // table rows searched a piece
static_assert(2 * kDenseTable <= 4 * kDenseStage,
              "a piece's search scratch (2 ints a row) fits the stage");
static_assert((kDenseRuns & (kDenseRuns - 1)) == 0
                  && kDenseRuns * kDenseCols % kDenseThreads == 0,
              "the run search steps by powers of two; whole weight rounds");
using bm25::cta_scan;

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

__global__ void __launch_bounds__(kDenseThreads, 1) dense_score_kernel(
    const int* __restrict__ tok, const int* __restrict__ loc,
    const float* __restrict__ sc, int p_pad, const int* __restrict__ uniq,
    int n_uniq, const float* __restrict__ w, int n_cols, int block_size,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [block_size][64]
  int4* stage = reinterpret_cast<int4*>(
      acc + static_cast<size_t>(block_size) * kDenseCols);  // [kDenseStage]
  float* wst = reinterpret_cast<float*>(stage + kDenseStage);  // [runs][64]
  int* counts = reinterpret_cast<int*>(wst + kDenseRuns * kDenseCols);
  int* run_u = counts + kDenseCounts;               // [kDenseTable]
  int* run_lo = run_u + kDenseTable;                // [kDenseTable]
  int* run_off = run_lo + kDenseTable;              // [kDenseTable + 1]
  __shared__ unsigned long long s_scan[kDenseWarps];
  __shared__ int s_seg[kDenseWarps + 1];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long blk = blockIdx.y;
  const int col0 = blockIdx.x * kDenseCols;
  const int* tb = tok + blk * p_pad;
  const int* lb = loc + blk * p_pad;
  const float* sb = sc + blk * p_pad;

  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = tid; i < block_size * (kDenseCols / 4); i += kDenseThreads)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the owner counts start at zero (and are zeroed again during each walk)
  for (int i = tid; i < kDenseCounts; i += kDenseThreads) counts[i] = 0;

  // do the real tokens ascend, -1 pads after them? and how many are real;
  // four consecutive tokens a thread, their loads in flight together
  unsigned long long real = 0;
  bool bad = false;
#pragma unroll 4
  for (int p0 = 4 * tid; p0 < p_pad; p0 += 4 * kDenseThreads) {
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
  const int n_real = static_cast<int>(n_real_ll);

  // sorted: the matched postings as runs, one a table row, in table order,
  // the table taken kDenseTable rows a piece (a later piece's runs follow
  // an earlier one's in posting order); any other order: one piece
  const int stride = max(1, (n_real + kDenseRuns * kDenseCols - 1)
                                / (kDenseRuns * kDenseCols));
  const int n_samp = (n_real + stride - 1) / stride;
  const int n_pieces =
      sorted ? max(1, (n_uniq + kDenseTable - 1) / kDenseTable) : 1;
  const int col = col0 + 2 * lane;                  // my two columns
  for (int piece = 0; piece < n_pieces; ++piece) {
    const int u0 = piece * kDenseTable;
    const int n_piece = min(kDenseTable, n_uniq - u0);
    int n_runs = 0, n_matched = 0;
    if (sorted) {
      int* t_lo = reinterpret_cast<int*>(stage);      // scratch [kDenseTable]
      int* t_len = t_lo + kDenseTable;                // scratch [kDenseTable]
      int* samp = reinterpret_cast<int*>(wst);        // scratch samples
      for (int j = tid; j < n_samp; j += kDenseThreads)
        samp[j] = tb[j * stride];
      __syncthreads();
      for (int v = tid; v < n_piece; v += kDenseThreads) {
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
      const int g = (n_piece + kDenseThreads - 1) / kDenseThreads;
      const int g0 = min(tid * g, n_piece), g1 = min(g0 + g, n_piece);
      unsigned long long mine = 0;                    // runs << 32 | postings
      for (int v = g0; v < g1; ++v)
        if (t_len[v] > 0) mine += (1ull << 32) + t_len[v];
      unsigned long long total;
      const unsigned long long at = cta_scan(mine, s_scan, total);
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

    // rounds of at most kDenseStage postings: matched runs (sorted), or every
    // posting with its token searched in the table (any other order)
    const int n_total = sorted ? n_matched : p_pad;
    int r0 = 0;                                       // run holding m0
    for (int m0 = 0; m0 < n_total;) {
      int m1;
      // this thread's postings m0 + tid + j * 512 and weights: every load
      // of the round issued before the first one is used
      constexpr int kW = kDenseRuns * kDenseCols / kDenseThreads;
      int pos[kDensePer], slot[kDensePer];
      float wreg[kW];
      int r_end = 0;
      if (sorted) {
        r_end = min(r0 + kDenseRuns, n_runs);
        m1 = min(m0 + kDenseStage, run_off[r_end]);
#pragma unroll
        for (int j = 0; j < kW; ++j) {          // the runs' weight rows
          const int i = tid + j * kDenseThreads;
          const int c = col0 + (i % kDenseCols);
          wreg[j] = r0 + i / kDenseCols < r_end && c < n_cols
                        ? w[static_cast<size_t>(run_u[r0 + i / kDenseCols])
                                * n_cols + c]
                        : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kDensePer; ++j) {
          const int m = m0 + tid + j * kDenseThreads;
          int lo = r0;            // the last run starting <= m, in a
#pragma unroll                          // fixed number of steps
          for (int step = kDenseRuns / 2; step > 0; step >>= 1)
            if (lo + step < r_end && run_off[lo + step] <= m) lo += step;
          pos[j] = m < m1 ? run_lo[lo] + (m - run_off[lo]) : -1;
          slot[j] = lo - r0;
        }
      } else {
        m1 = min(m0 + kDenseStage, p_pad);
#pragma unroll
        for (int j = 0; j < kDensePer; ++j) {
          const int p = m0 + tid + j * kDenseThreads;
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
      int4 ent[kDensePer];
#pragma unroll
      for (int j = 0; j < kDensePer; ++j)
        ent[j] = pos[j] >= 0
                     ? make_int4(lb[pos[j]], __float_as_int(sb[pos[j]]),
                                 slot[j], 0)
                     : make_int4(-1, 0, slot[j], 0);
      if (sorted) {
#pragma unroll
        for (int j = 0; j < kW; ++j) wst[tid + j * kDenseThreads] = wreg[j];
      }
      bm25::owner_round(ent, block_size, sorted, wst, w, n_cols, col, acc,
                        stage, counts, s_scan, s_seg);
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

  // every row written, a lane per column: 128 contiguous bytes a store
  for (int row = warp; row < block_size; row += kDenseWarps) {
    float* o = out + (blk * block_size + row) * n_cols + col0;
#pragma unroll
    for (int h = 0; h < kDenseCols; h += 32) {
      if (col0 + h + lane < n_cols)
        o[h + lane] = acc[row * kDenseCols + h + lane];
    }
  }
}

}  // namespace

// Dynamic shared memory K2 needs, in bytes.
extern "C" long long bm25_block_score_smem(int block_size, int n_uniq) {
  return static_cast<long long>(block_size) * kLd * 4
         + static_cast<long long>(n_uniq) * 4 + bm25::kScatterStagingBytes;
}

// Launch on `stream`; returns the CUDA error code (0 on success).
extern "C" int bm25_block_score_topk_launch(
    const void* tok, const void* loc, const void* sc, int n_blocks,
    int p_pad, const void* uniq, int n_uniq, const void* w, int n_cols,
    int block_size, int k, long long n_docs, void* out_v, void* out_i,
    void* stream) {
  const long long smem = bm25_block_score_smem(block_size, n_uniq);
  cudaError_t err = cudaFuncSetAttribute(
      block_score_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + kCols - 1) / kCols, n_blocks);
  block_score_topk_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<const int*>(loc),
      static_cast<const float*>(sc), p_pad, static_cast<const int*>(uniq),
      n_uniq, static_cast<const float*>(w), n_cols, block_size, k, n_docs,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory K6 needs, in bytes: the [block_size, 64]
// accumulator, the staged postings, weight rows and owner counts, and the
// run table of one piece of the unique table (any number of table rows).
extern "C" long long bm25_block_score_dense_smem(int block_size) {
  return static_cast<long long>(block_size) * kDenseCols * 4
         + kDenseStage * 16LL + kDenseRuns * kDenseCols * 4LL
         + kDenseCounts * 4LL + (3LL * kDenseTable + 1) * 4;
}

// Launch K6 on `stream`; returns the CUDA error code (0 on success).
extern "C" int bm25_block_score_launch(
    const void* tok, const void* loc, const void* sc, int n_blocks,
    int p_pad, const void* uniq, int n_uniq, const void* w, int n_cols,
    int block_size, void* out, void* stream) {
  const long long smem = bm25_block_score_dense_smem(block_size);
  cudaError_t err = cudaFuncSetAttribute(
      dense_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + kDenseCols - 1) / kDenseCols, n_blocks);
  dense_score_kernel<<<grid, kDenseThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<const int*>(loc),
      static_cast<const float*>(sc), p_pad, static_cast<const int*>(uniq),
      n_uniq, static_cast<const float*>(w), n_cols, block_size,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
