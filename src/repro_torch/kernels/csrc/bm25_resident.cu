// K1: resident gather -> score -> top-k over fragment descriptors, and
// K3: the same with the block-max skip (the pruned regime).
//
// Replaces: src/repro/kernels/bm25_gather_score.py::bm25_resident_score_topk
// (bodies _resident_kernel / _resident_kernel_db with _resident_scatter,
// _resident_fold and _fold_winners; pallas_call at bm25_gather_score.py:661)
// and src/repro/kernels/bm25_gather_score.py::bm25_resident_score_topk_pruned
// (body _resident_kernel_pruned; pallas_call at bm25_gather_score.py:574).
// As in the reference, both share one scatter and one fold: here one kernel
// template, instantiated with and without the skip.
//
// What it computes. `desc` is the [6, nf] fragment table of
// repro_torch.sparse.block_csr.fragment_plan (rows start, valid, uniq,
// block, first, last); a block's fragments are contiguous (a span), and a
// fragment's postings are one CSC run, so their documents are distinct.
// For every span, in table order:
//   acc[d, b] += fl(score[start + j] * w[uniq, b]) for each posting j <
//               valid of each fragment, d = doc[start + j] - block * bs;
//   rows whose doc id is >= n_docs are padding (-FLT_MAX, id -1);
// and the output is the [k, B] board of the best (score, doc id) entries
// over all visited blocks, in (score desc, id asc) order, id -1 wherever
// the score is the padding value. K3 takes one more operand, the [nb, B]
// per-block upper bounds (already slack-inflated), and skips a span when
// no column of the CTA's column group can still reach its board: the
// board is the same as K1's in every column whose bounds are finite, and
// K3 also reports how many real fragments it skipped.
//
// Bound on the H100: each gathered posting is read once (8 bytes against
// 3.35 TB/s) and costs one FP32 multiply and one add per query column
// (2 operations against 67 TFLOP/s); at B = 256 the operations dominate
// (0.671 ms at phase 5's 87.8 M postings). K3 also reads one bound row per
// span, and every span it skips removes that span's postings from the
// work. In practice the limit is the shared-memory read-modify-write of
// the accumulator, as in K6, which adds the same (posting, column)
// products.
//
// What the first version lost, 263.5 ms at phase 5's shapes: a
// CTA held 32 columns, so each of 8 column tiles re-read every posting and
// descriptor; every fragment (about 48 postings at full width) cost a
// barrier and three dependent global trips (flag, descriptor, postings);
// each span's fold took k rounds a column, each a scan of the whole
// column, a butterfly and a dependent read of the board's head; and the
// table was cut into slices by fragment count, padding included.
//
// Design, one CTA of 16 warps a (column group of 64, range of spans), two
// columns a lane, a [512, 64] f32 accumulator in shared memory
// (128 KB at block 512, one CTA an SM), K6's schedule on the fragment
// table:
// * The grid is persistent: G ranges a column group, about one CTA an SM.
//   The wrapper cuts the table into G ranges of whole spans balanced by
//   posting count, on the card (a cumulative sum of `valid`, a search and
//   the next span leader), so no range splits a span and pads take none.
// * A span is walked in windows of up to 2,048 fragments: one load of
//   their descriptors (all in flight), a CTA minimum for the span's last
//   fragment, and one scan of `valid` that lays the window's real
//   fragments out as runs (start, weight row, first posting). No barrier a
//   fragment.
// * Rounds of up to 2,048 postings and 128 runs load every posting, its
//   run's weights (staged in shared memory) and its row at once, then
//   owner_round.cuh (shared with K6) partitions them stably by owner warp
//   (row % 16) and each warp adds its list in table order: one writer an
//   element, in table order, __fmul_rn then __fadd_rn, no atomics, so the
//   sums are the twin's bit for bit.
// * The fold takes K5's threshold in place of k rounds. Each CTA keeps its
//   running board in device memory ([G, B, k], a column's k rows
//   contiguous) and the board's row k - 1 of each column in shared memory.
//   After a span each warp marks, for its two columns, which of its 32
//   rows rank before that row (one conflict-free pass); then each warp
//   takes 4 columns and merges only the marked rows, 32 at a time, into
//   the sorted board by rank: a board entry moves down by the candidates
//   ahead of it, a candidate lands at the count of the entries and
//   candidates ahead of it (ballots, no sort), the board rewritten in
//   place from its last rows up. Once the board is full a span costs one
//   pass over its rows and a few merges, not k rounds a column. The fold
//   is threshold_fold.cuh, shared with K2 and K4. The boards of the G
//   CTAs are merged by board_merge.cuh, as before.
// * A block of more than kFoldRows (512) rows is taken in windows of 512
//   rows, as K2 takes its blocks (block_topk.cuh): the accumulator holds
//   one window ([512, 64]), the span is walked once a window with rows
//   shifted by the window's base, and each window is folded into the
//   running board before the next. A fragment is one CSC run of one token,
//   whose doc ids ascend, so two searches of its postings cut out the
//   window's part and a window reads no posting of another (blocks of at
//   most 512 rows take the one window and no search). Rows past n_docs
//   are never marked, in every window. A document's postings all fall in
//   one window and are added in the same order as in one pass, and the
//   board is a sorted set under a total order, so the windows change no
//   bit of it.
// * K3's skip is decided once per span, at its first fragment, against
//   the CTA's OWN running board: skip iff bound[block(f), c] < board[k-1,
//   c] for every column c of the group. That board holds k real documents
//   with full scores (or the float minimum), so its row k-1 is a certified
//   lower bound on the final k-th score, and a span that cannot beat it
//   cannot change the merged board. A span is never switched from scoring
//   to skipping part way (a partly scored block would fold a wrong score),
//   so a threshold from another CTA is not consulted. A skipped span adds
//   and folds nothing; each CTA writes its count of skipped real fragments
//   to its own slot (no atomics), and the wrapper sums them. Padding
//   columns (-inf bounds) never keep a span alive.
#include "board_merge.cuh"
#include "owner_round.cuh"
#include "threshold_fold.cuh"

namespace {

constexpr int kThreads = bm25::kRoundThreads;
constexpr int kWarps = bm25::kRoundWarps;
constexpr int kCols = bm25::kRoundCols;
constexpr int kStage = bm25::kRoundStage;
constexpr int kPer = bm25::kRoundPer;
constexpr int kRuns = bm25::kRoundRuns;
constexpr int kCounts = bm25::kRoundCounts;
constexpr int kWindow = 2048;                // fragments a window
constexpr int kWinPer = kWindow / kThreads;  // a thread's share
constexpr int kRowWindow = bm25::kFoldRows;  // rows a window (one mask)
constexpr unsigned kFull = 0xffffffffu;
static_assert(bm25::kFoldMaskBytes <= kStage * 16,
              "the fold's row masks fit the stage");

// The first j in [0, n) with doc[lo + j] >= key, or n; doc[lo ..
// lo + n) ascends.
__device__ __forceinline__ int first_at_least(const int* __restrict__ doc,
                                              int lo, int n, long long key) {
  int a = 0, b = n;
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (doc[lo + mid] < key) a = mid + 1; else b = mid;
  }
  return a;
}

// kPruned = false: K1. kPruned = true: K3 (reads `bounds` [nb, n_cols],
// writes its skipped-fragment count to skips[blockIdx.y * gridDim.x +
// blockIdx.x]). CTA (x, y) takes columns [64 x, 64 x + 64) and the spans
// whose leaders lie in [ranges[y], ranges[y + 1]); each range boundary is
// a span leader or nf_pad.
template <bool kPruned>
__global__ void __launch_bounds__(kThreads, 1) resident_topk_kernel(
    const int* __restrict__ desc, int nf_pad, const int* __restrict__ ranges,
    const float* __restrict__ w, int n_cols,
    const int* __restrict__ doc_res, const float* __restrict__ sc_res,
    int block_size, int k, long long n_docs,
    const float* __restrict__ bounds, float* __restrict__ board_v,
    int* __restrict__ board_g, int* __restrict__ skips) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int acc_rows = min(block_size, kRowWindow);
  const int n_row_windows = (block_size + kRowWindow - 1) / kRowWindow;
  float* acc = reinterpret_cast<float*>(smem_raw);  // [acc_rows][64]
  int4* stage = reinterpret_cast<int4*>(
      acc + static_cast<size_t>(acc_rows) * kCols);  // [kStage]
  float* wst = reinterpret_cast<float*>(stage + kStage);  // [kRuns][64]
  int* counts = reinterpret_cast<int*>(wst + kRuns * kCols);
  int* run_u = counts + kCounts;                    // [kWindow]
  int* run_lo = run_u + kWindow;                    // [kWindow]
  int* run_off = run_lo + kWindow;                  // [kWindow + 1]
  float* thr_v = reinterpret_cast<float*>(run_off + kWindow + 1);  // [64]
  int* thr_g = reinterpret_cast<int*>(thr_v + kCols);              // [64]
  __shared__ unsigned long long s_scan[kWarps];
  __shared__ int s_seg[kWarps + 1];
  __shared__ unsigned s_min[kWarps];

  const int* d_start = desc;
  const int* d_valid = desc + nf_pad;
  const int* d_uniq = desc + 2 * static_cast<size_t>(nf_pad);
  const int* d_blk = desc + 3 * static_cast<size_t>(nf_pad);
  const int* d_first = desc + 4 * static_cast<size_t>(nf_pad);
  const int* d_last = desc + 5 * static_cast<size_t>(nf_pad);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + 2 * lane;                  // my two columns
  // this CTA's board: column c's k rows at my_v[c * k]
  float* my_v = board_v + (static_cast<size_t>(blockIdx.y) * n_cols + col0)
                              * k;
  int* my_g = board_g + (static_cast<size_t>(blockIdx.y) * n_cols + col0)
                            * k;
  const int n_mine = min(kCols, n_cols - col0);     // columns of the group

  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = tid; i < acc_rows * (kCols / 4); i += kThreads)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < kCounts; i += kThreads) counts[i] = 0;
  for (int i = tid; i < n_mine * k; i += kThreads) {
    my_v[i] = -FLT_MAX;
    my_g[i] = -1;
  }
  if (tid < kCols) {
    thr_v[tid] = -FLT_MAX;
    thr_g[tid] = -1;
  }
  __syncthreads();

  int n_skipped = 0;  // real fragments of skipped spans this thread counted
  const int f_end = ranges[blockIdx.y + 1];
  for (int f = ranges[blockIdx.y]; f < f_end;) {     // f leads a span
    const long long blk = d_blk[f];
    const long long base = blk * block_size;
    bool dead = false;
    if constexpr (kPruned) {
      // decide the whole span now, against this CTA's own board
      const bool alive =
          tid < n_mine
          && !(bounds[blk * n_cols + col0 + tid] < thr_v[tid]);
      dead = !__syncthreads_or(alive);
    }
    int last = f;                                   // the span's last
    // a dead span is walked once, to find its end and count its fragments
    const int n_rw = dead ? 1 : n_row_windows;
    for (int rw = 0; rw < n_rw; ++rw) {   // windows of the block's rows
      const long long wbase = base + static_cast<long long>(rw) * kRowWindow;
      const int w_rows = min(kRowWindow, block_size - rw * kRowWindow);
      const bool split = n_rw > 1;          // cut each fragment to the window
      for (int fw = f;; fw += kWindow) {    // windows of the span's fragments
        const int g0 = fw + kWinPer * tid;            // mine: g0 + j
        int val[kWinPer], st[kWinPer], un[kWinPer];
        unsigned my_e = INT_MAX;
#pragma unroll
        for (int j = 0; j < kWinPer; ++j) {
          const int g = g0 + j;
          const bool in = g < f_end;
          val[j] = in ? d_valid[g] : 0;
          st[j] = in ? d_start[g] : 0;
          un[j] = in ? d_uniq[g] : 0;
          if ((!in || d_last[g] || g + 1 == f_end)
              && static_cast<unsigned>(g) < my_e)
            my_e = g;
        }
        my_e = __reduce_min_sync(kFull, my_e);
        if (lane == 0) s_min[warp] = my_e;
        __syncthreads();
        unsigned e = s_min[0];
#pragma unroll
        for (int i = 1; i < kWarps; ++i) e = min(e, s_min[i]);
        const int w_end = static_cast<int>(
            min(e, static_cast<unsigned>(fw + kWindow - 1)));
        if (split) {
          // a fragment's doc ids ascend: its postings in [wbase, wbase +
          // w_rows) are one contiguous part of it
#pragma unroll
          for (int j = 0; j < kWinPer; ++j) {
            if (g0 + j > w_end || val[j] <= 0) continue;
            const int lo = first_at_least(doc_res, st[j], val[j], wbase);
            const int hi = first_at_least(doc_res, st[j], val[j],
                                          wbase + w_rows);
            st[j] += lo;
            val[j] = hi - lo;
          }
        }
        unsigned long long mine = 0;                  // runs << 32 | postings
#pragma unroll
        for (int j = 0; j < kWinPer; ++j)
          if (g0 + j <= w_end && val[j] > 0) mine += (1ull << 32) + val[j];
        if (dead) {
          n_skipped += static_cast<int>(mine >> 32);
          __syncthreads();                            // s_min is read
        } else {
          // the window's real fragments as runs, in table order
          unsigned long long total;
          const unsigned long long at = bm25::cta_scan(mine, s_scan, total);
          const int n_runs = static_cast<int>(total >> 32);
          const int n_matched = static_cast<int>(total & 0xffffffffu);
          int r = static_cast<int>(at >> 32), m = static_cast<int>(at);
#pragma unroll
          for (int j = 0; j < kWinPer; ++j) {
            if (g0 + j > w_end || val[j] <= 0) continue;
            run_u[r] = un[j];
            run_lo[r] = st[j];
            run_off[r] = m;
            m += val[j];
            ++r;
          }
          if (tid == 0) run_off[n_runs] = n_matched;
          __syncthreads();

          // rounds of at most kStage postings and kRuns runs
          int r0 = 0;                                 // run holding m0
          for (int m0 = 0; m0 < n_matched;) {
            const int r_end = min(r0 + kRuns, n_runs);
            const int m1 = min(m0 + kStage, run_off[r_end]);
            // this thread's postings m0 + tid + j * 512 and weights: every
            // load of the round issued before the first one is used
            constexpr int kW = kRuns * kCols / kThreads;
            int pos[kPer], slot[kPer];
            float wreg[kW];
#pragma unroll
            for (int j = 0; j < kW; ++j) {            // the runs' weight rows
              const int i = tid + j * kThreads;
              const int c = col0 + (i % kCols);
              wreg[j] = r0 + i / kCols < r_end && c < n_cols
                            ? w[static_cast<size_t>(run_u[r0 + i / kCols])
                                    * n_cols + c]
                            : 0.f;
            }
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              const int mm = m0 + tid + j * kThreads;
              int lo = r0;          // the last run starting <= mm, in a
#pragma unroll                          // fixed number of steps
              for (int step = kRuns / 2; step > 0; step >>= 1)
                if (lo + step < r_end && run_off[lo + step] <= mm) lo += step;
              pos[j] = mm < m1 ? run_lo[lo] + (mm - run_off[lo]) : -1;
              slot[j] = lo - r0;
            }
            int4 ent[kPer];
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              if (pos[j] >= 0) {
                const long long row = doc_res[pos[j]] - wbase;
                ent[j] = make_int4(
                    row >= 0 && row < w_rows ? static_cast<int>(row) : -1,
                    __float_as_int(sc_res[pos[j]]), slot[j], 0);
              } else {
                ent[j] = make_int4(-1, 0, slot[j], 0);
              }
            }
#pragma unroll
            for (int j = 0; j < kW; ++j) wst[tid + j * kThreads] = wreg[j];
            bm25::owner_round(ent, w_rows, true, wst, w, n_cols, col, acc,
                              stage, counts, s_scan, s_seg);
            m0 = m1;
            if (m0 < n_matched) {                     // the run holding m0
              int lo = r0, hi = n_runs - 1;
              while (lo < hi) {
                const int mid = (lo + hi + 1) >> 1;
                if (run_off[mid] <= m0) lo = mid; else hi = mid - 1;
              }
              r0 = lo;
            }
          }
        }
        if (static_cast<int>(e) <= fw + kWindow - 1) {
          last = static_cast<int>(e);
          break;
        }
      }

      if (!dead) {
        // the fold (threshold_fold.cuh): rows past n_docs are padding, which
        // never ranks before the board's row k - 1
        unsigned* masks = reinterpret_cast<unsigned*>(stage);  // [16][64]
        const int n_rows = static_cast<int>(
            max(0LL, min(static_cast<long long>(w_rows), n_docs - wbase)));
        const auto raw = [](int, float v) { return v; };
        const auto gid = [wbase](int row) {
          return static_cast<int>(wbase + row);
        };
        bm25::fold_mark(acc, n_rows, n_mine, thr_v, thr_g, raw, gid, masks);
        __syncthreads();
        bm25::fold_merge(acc, masks, n_mine, k, my_v, my_g, thr_v, thr_g, raw,
                         gid);
        __syncthreads();                              // acc is read
        for (int i = tid; i < w_rows * (kCols / 4); i += kThreads)
          acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    f = last + 1;
    if (f >= f_end || !d_first[f]) break;           // padding follows
  }

  if constexpr (kPruned) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n_skipped += __shfl_xor_sync(kFull, n_skipped, off);
    }
    __syncthreads();                                // s_min is free
    if (lane == 0) s_min[warp] = static_cast<unsigned>(n_skipped);
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int i = 0; i < kWarps; ++i) total += static_cast<int>(s_min[i]);
      skips[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = total;
    }
  }
}

}  // namespace

// Dynamic shared memory of the scoring kernel, in bytes (any k): the
// accumulator of one row window, the staged postings, weights and owner
// counts, the window's run table and the thresholds.
constexpr long long smem_bytes(int block_size) {
  return static_cast<long long>(
             block_size < kRowWindow ? block_size : kRowWindow) * kCols * 4
         + kStage * 16LL
         + kRuns * kCols * 4LL + kCounts * 4LL + (3LL * kWindow + 1) * 4
         + 2LL * kCols * 4;
}
static_assert(smem_bytes(kRowWindow) + 1024 <= 232448,
              "a row window fits a CTA beside the static shared memory");

namespace {

// Launch the scoring kernel and the board merge on `stream`; returns the
// CUDA error code (0 = ok).
template <bool kPruned>
int launch_resident(const void* desc, int nf_pad, const void* ranges,
                    int n_ranges, const void* w, int n_cols,
                    const void* bounds, const void* doc_res,
                    const void* sc_res, int block_size, int k,
                    long long n_docs, void* board_v, void* board_g,
                    void* skips, void* out_v, void* out_g, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_size < 1 || k < 1 || k > block_size || n_ranges < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = smem_bytes(block_size);
  cudaError_t err = cudaFuncSetAttribute(
      resident_topk_kernel<kPruned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + kCols - 1) / kCols, n_ranges);
  resident_topk_kernel<kPruned>
      <<<grid, kThreads, static_cast<size_t>(smem), s>>>(
          static_cast<const int*>(desc), nf_pad,
          static_cast<const int*>(ranges), static_cast<const float*>(w),
          n_cols, static_cast<const int*>(doc_res),
          static_cast<const float*>(sc_res), block_size, k, n_docs,
          static_cast<const float*>(bounds), static_cast<float*>(board_v),
          static_cast<int*>(board_g), static_cast<int*>(skips));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(bm25::launch_board_merge(
      static_cast<const float*>(board_v), static_cast<const int*>(board_g),
      n_ranges, k, n_cols, static_cast<float*>(out_v),
      static_cast<int*>(out_g), s, /*col_major=*/true));
}

}  // namespace

// K1. ranges is [n_ranges + 1] int32 (span leaders, then nf_pad);
// board_v / board_g are [n_ranges, n_cols, k] scratch, out_* [k, n_cols].
extern "C" int bm25_resident_topk_launch(
    const void* desc, int nf_pad, const void* ranges, int n_ranges,
    const void* w, int n_cols, const void* doc_res, const void* sc_res,
    int block_size, int k, long long n_docs, void* board_v, void* board_g,
    void* out_v, void* out_g, void* stream) {
  return launch_resident<false>(desc, nf_pad, ranges, n_ranges, w, n_cols,
                                nullptr, doc_res, sc_res, block_size, k,
                                n_docs, board_v, board_g, nullptr, out_v,
                                out_g, stream);
}

// K3. bounds is [nb, n_cols] f32, one row per block (every block the
// table names); skips is [n_ranges * n_groups] int32, one count of
// skipped real fragments per CTA.
extern "C" int bm25_resident_pruned_launch(
    const void* desc, int nf_pad, const void* ranges, int n_ranges,
    const void* w, int n_cols, const void* bounds, const void* doc_res,
    const void* sc_res, int block_size, int k, long long n_docs,
    void* board_v, void* board_g, void* skips, void* out_v, void* out_g,
    void* stream) {
  return launch_resident<true>(desc, nf_pad, ranges, n_ranges, w, n_cols,
                               bounds, doc_res, sc_res, block_size, k,
                               n_docs, board_v, board_g, skips, out_v,
                               out_g, stream);
}
