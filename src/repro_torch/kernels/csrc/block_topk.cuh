// One block's top-k a query column, shared by K2 (bm25_block_score.cu,
// block_score_topk_kernel: a document block of the full scan) and K4
// (bm25_gather_score.cu, gather_score_topk_kernel: a chunk of
// host-gathered candidates, whose rows are candidate slots).
//
// A CTA of 16 warps takes one (block, group of 64 query columns), as K6
// does. The block's rows are taken in windows of kTopkWindow (512): each
// window is one walk of block_walk.cuh (the runs matched once, owner
// rounds, sums in posting order with __fmul_rn then __fadd_rn, no
// atomics) into a [512, 64] shared accumulator, with rows shifted by the
// window's base, then one fold of threshold_fold.cuh. Rows past n_docs
// (K2) or of padding slots (K4) take -FLT_MAX: a padded row's 0.0 would
// outrank real negative scores (robertson IDF), and when a block holds
// fewer than k real rows its padding rows are still taken, in row order.
// Ties rank by row ascending: block-local rows for K2, candidate slots for
// K4, whose real candidates ascend with the slot (gather_posting_runs),
// so slot order is doc id order. Both kernels take any U (the walk
// searches the table a piece at a time) and any number of rows.
//
// The fold. A block of one window (at most 512 rows; the main path's
// blocks of 512) takes fold_select: each column's k-th key by a bitwise
// search of counts, the rows above it ranked by count, the ties at it in
// row order, kSelectK (128) board rows a pass (k = 100 in one pass, k up
// to 512 in four); each pass's [kp, 64] board is staged over the
// accumulator, which it has read into registers, and written out
// coalesced. A block of more windows folds each window by fold_mark and
// fold_merge into a board in a device-memory scratch of the caller's
// ([n_blocks, n_cols, k], each column's k rows contiguous, as K1's
// boards), which starts empty ((-INF, INT_MAX) entries, below -FLT_MAX);
// a later window merges only the rows that beat the board's row k - 1.
// That path is exact but slow on an empty board (every row a candidate,
// merged 32 at a time): with it for every block, K2 took 93.2 ms at
// k = 100 and 32.4 at k = 1 at the full-width retriever's shapes on an
// H100 80GB HBM3 at 700 W.
#pragma once

#include <cfloat>
#include <climits>

#include "block_walk.cuh"
#include "threshold_fold.cuh"

namespace bm25 {

constexpr int kTopkWindow = kFoldRows;   // rows a window (one row mask)
static_assert(kSelectScratchBytes <= kWalkScratchBytes,
              "fold_select's scratch fits the walk's");
static_assert(2 * kSelectK <= kTopkWindow,
              "a pass's staged board fits a window's accumulator");

// Does a block of `rows` rows take fold_select? If not, the launch needs
// the device-memory board.
__host__ __device__ constexpr bool block_topk_selects(int rows) {
  return rows <= kTopkWindow;
}

// Rows of the accumulator's shared memory: one window, or a pass's staged
// board of fold_select ([min(k, 128), 64] values and rows, k <= rows) if
// that is larger.
__host__ __device__ constexpr int block_topk_acc_rows(int rows) {
  return rows >= kTopkWindow ? kTopkWindow
         : rows >= 2 * kSelectK ? rows
         : 2 * (rows < kSelectK ? rows : kSelectK);
}

// Dynamic shared memory of a block of `rows` rows, in bytes: the
// accumulator, the walk's scratch and the 64 thresholds.
constexpr long long block_topk_smem(int rows) {
  return static_cast<long long>(block_topk_acc_rows(rows)) * kRoundCols * 4
         + kWalkScratchBytes + 2LL * kRoundCols * 4;
}
static_assert(block_topk_smem(kTopkWindow) + 1024 <= 232448,
              "a window fits a CTA beside the static shared memory");

// kCand = false: K2. Rows are the block's documents (row r of block b is
// doc b * rows + r), those >= n_docs are padding, ids are rows.
// kCand = true: K4. Rows are candidate slots, cand[b * rows + r] < 0 is
// padding, and the written id is cand[b * rows + slot] (-1 for padding).
// board_v / board_g: the device-memory board when block_topk_selects is
// false, else null. Columns past n_cols are neither read nor written;
// k <= rows.
template <bool kCand>
__device__ __forceinline__ void block_topk(
    const int* __restrict__ tok, const int* __restrict__ loc,
    const float* __restrict__ sc, int p_pad, const int* __restrict__ uniq,
    int n_uniq, const float* __restrict__ w, int n_cols, int rows, int k,
    long long n_docs, const int* __restrict__ cand, float* __restrict__ out_v,
    int* __restrict__ out_i, float* board_v, int* board_g,
    unsigned char* smem, unsigned long long* s_scan, int* s_seg) {
  const int tid = threadIdx.x;
  const long long blk = blockIdx.y;
  const int col0 = blockIdx.x * kRoundCols;
  const int n_mine = min(kRoundCols, n_cols - col0);   // columns a group
  const int acc_rows = min(rows, kTopkWindow);
  const WalkSmem s = walk_carve(smem, block_topk_acc_rows(rows), s_scan,
                                s_seg);
  const bool select = board_v == nullptr;
  float* thr_v = reinterpret_cast<float*>(s.end);        // [64]
  int* thr_g = reinterpret_cast<int*>(thr_v + kRoundCols);  // [64]
  const int* tb = tok + blk * p_pad;
  const int* lb = loc + blk * p_pad;
  const float* sb = sc + blk * p_pad;
  const int* cb = kCand ? cand + blk * rows : nullptr;
  if (!select) {
    // an empty board: k entries below every real one, and its row k - 1
    board_v += (blk * n_cols + col0) * k;
    board_g += (blk * n_cols + col0) * k;
    if (tid < kRoundCols) {
      thr_v[tid] = -INFINITY;
      thr_g[tid] = INT_MAX;
    }
    for (int i = tid; i < n_mine * k; i += kRoundThreads) {
      board_v[i] = -INFINITY;
      board_g[i] = INT_MAX;
    }
  }
  for (int i = tid; i < kRoundCounts; i += kRoundThreads) s.counts[i] = 0;
  float4* acc4 = reinterpret_cast<float4*>(s.acc);
  for (int i = tid; i < acc_rows * (kRoundCols / 4); i += kRoundThreads)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  int n_real;
  const bool sorted = tokens_ascend(tb, p_pad, s_scan, n_real);

  // board entry (r, c), value v and row g, to out[blk, r, col0 + c]: a
  // row of 64 columns is 256 contiguous bytes
  const auto put = [=](int r, int c, float v, int g) {
    const size_t o = (static_cast<size_t>(blk) * k + r) * n_cols + col0 + c;
    out_v[o] = v;
    out_i[o] = kCand ? cb[g] : g;
  };
  for (int row0 = 0; row0 < rows; row0 += kTopkWindow) {
    const int n_rows = min(kTopkWindow, rows - row0);
    if (row0 > 0) {                    // the last fold has read the window
      for (int i = tid; i < n_rows * (kRoundCols / 4); i += kRoundThreads)
        acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      __syncthreads();
    }
    walk_block(tb, lb, sb, p_pad, n_real, sorted, uniq, n_uniq, w, n_cols,
               col0, row0, n_rows, s);
    __syncthreads();                   // the window's sums are complete
    const auto value_of = [=](int row, float v) {
      const bool pad = kCand ? cb[row0 + row] < 0
                             : blk * rows + row0 + row >= n_docs;
      return pad ? -FLT_MAX : v;
    };
    if (select) {
      // a pass's [kp, 64] staged values and rows, over the accumulator
      float* stv = s.acc;
      int* stg = reinterpret_cast<int*>(s.acc + min(k, kSelectK)
                                        * kRoundCols);
      fold_select(s.acc, n_rows, k, value_of,
                  reinterpret_cast<unsigned char*>(s.stage), stv, stg,
                  [=](int r0, int kp) {
                    for (int i = tid; i < kp * kRoundCols;
                         i += kRoundThreads) {
                      const int c = i % kRoundCols;
                      if (c < n_mine)
                        put(r0 + i / kRoundCols, c, stv[i], stg[i]);
                    }
                  });
    } else {
      unsigned* masks = reinterpret_cast<unsigned*>(s.stage);  // [16][64]
      const auto id_of = [row0](int row) { return row0 + row; };
      fold_mark(s.acc, n_rows, n_mine, thr_v, thr_g, value_of, id_of,
                masks);
      __syncthreads();
      fold_merge(s.acc, masks, n_mine, k, board_v, board_g, thr_v, thr_g,
                 value_of, id_of);
      __syncthreads();                 // the board is complete
    }
  }
  if (!select) {
    for (int i = tid; i < k * kRoundCols; i += kRoundThreads) {
      const int r = i / kRoundCols, c = i % kRoundCols;
      if (c < n_mine) put(r, c, board_v[c * k + r], board_g[c * k + r]);
    }
  }
}

}  // namespace bm25
