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
// block, first, last); a block's fragments are contiguous (a span). For
// every span, in table order:
//   acc[d, b] += fl(score[start + j] * w[uniq, b]) for each posting j <
//               valid of each fragment, d = doc[start + j] - block * bs;
//   rows whose doc id is >= n_docs are padding (-FLT_MAX, id -1);
// and the output is the [k, B] board of the best (score, doc id) entries
// over all visited blocks, in (score desc, id asc) order, id -1 wherever
// the score is the padding value. K3 takes one more operand, the [nb, B]
// per-block upper bounds (already slack-inflated), and skips a span when
// no column of the CTA's B-tile can still reach its board: the board is
// the same as K1's in every column whose bounds are finite, and K3 also
// reports how many real fragments it skipped.
//
// Bound on the H100: each gathered posting is read once (8 bytes against
// 3.35 TB/s) and costs one FP32 multiply and one add per query column
// (2 operations against 67 TFLOP/s); at B = 256 the adds dominate. K3
// also reads one bound row per span, at its first fragment (4 bytes a
// column; the span's block), and every span it skips removes that span's
// postings from the work. The fragment walk is latency-bound in this
// first version: one barrier per fragment, and fragments of Zipf tails
// hold few postings.
//
// Design:
// * The TPU grid walks the fragment table in order with one [block, B]
//   VMEM accumulator. Here CTAs run in parallel: grid = (B-tile, G). CTA g
//   owns the spans whose first fragment lies in its slice of the table
//   [g * F, (g + 1) * F); it finds its first span leader with one
//   block-wide search and walks each span's fragments in table order, so
//   no prologue pass is needed. A span that runs past the slice is
//   finished by the CTA that started it.
// * The [block_size, B] accumulator does not fit a CTA's shared memory
//   (512 KB at 512 x 256), so B is split into tiles of bt <= 32 columns;
//   rows are padded to bt + 1 words so a warp reading one column of 32
//   rows touches 32 distinct shared-memory banks.
// * Postings of one fragment belong to one CSC run, so their doc ids are
//   distinct: threads over (posting, column) pairs add without conflicts,
//   and a barrier between fragments keeps the per-element order equal to
//   table order. No atomics; __fmul_rn / __fadd_rn keep nvcc from fusing
//   the update into an FMA, so the plain torch twin matches bit for bit.
// * At a span's end each warp folds one column: k rounds that pick the
//   better of the accumulator's best untaken row and the head of the CTA's
//   sorted board (kept in the CTA's slice of the [G, k, B] output). The
//   cross-CTA merge that the TPU does inside its sequential grid is the
//   second kernel, board_merge.cuh: a warp per column merges the G sorted
//   boards.
// * K3's skip is decided once per span, at its first fragment, against the
//   CTA's OWN running board: skip iff bound[block(f), c] < board[k-1, c]
//   for every column c of the tile. That board holds k real documents with full
//   scores (or the float minimum), so its row k-1 is a certified lower
//   bound on the final k-th score, and a span that cannot beat it cannot
//   change the merged board. A span is never switched from scoring to
//   skipping part way (a partly scored block would fold a wrong score), so
//   a threshold from another CTA is not consulted (that needs a global
//   threshold, later work). A skipped span adds and folds nothing. Each
//   CTA writes its count of skipped real fragments to its own slot (no
//   atomics); the wrapper sums them.
#include "board_merge.cuh"
#include "select_topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // (posting, column) loads a thread keeps open

// Last fragment of the span that starts at f: the first g >= f whose
// `last` flag is set (or the table's end). Every thread of the CTA calls it
// and gets the same answer.
__device__ int span_end(const int* __restrict__ d_last, int f, int nf_pad,
                        int* s_end) {
  for (int lo = f;; lo += kThreads) {
    if (threadIdx.x == 0) *s_end = INT_MAX;
    __syncthreads();
    const int g = lo + static_cast<int>(threadIdx.x);
    if (g < nf_pad && (d_last[g] || g + 1 >= nf_pad)) atomicMin(s_end, g);
    __syncthreads();
    const int e = *s_end;
    __syncthreads();
    if (e != INT_MAX) return e;
  }
}

// kPruned = false: K1. kPruned = true: K3 (reads `bounds` [nb, n_cols],
// writes its skipped-fragment count to skips[blockIdx.y * gridDim.x +
// blockIdx.x]).
template <bool kPruned>
__global__ void __launch_bounds__(kThreads) resident_topk_kernel(
    const int* __restrict__ desc, int nf_pad, const float* __restrict__ w,
    int n_cols, const int* __restrict__ doc_res,
    const float* __restrict__ sc_res, int block_size, int k,
    long long n_docs, int frags_per_cta, int bt,
    const float* __restrict__ bounds, float* __restrict__ board_v,
    int* __restrict__ board_g, int* __restrict__ skips) {
  extern __shared__ unsigned char smem_raw[];
  const int ld = bt + 1;  // acc row stride: a column's rows in distinct banks
  float* acc = reinterpret_cast<float*>(smem_raw);  // [block_size * ld]
  float* st_v = acc + static_cast<size_t>(block_size) * ld;  // [k * bt]
  int* st_g = reinterpret_cast<int*>(st_v + static_cast<size_t>(k) * bt);
  __shared__ int s_lead;
  __shared__ int s_end;
  __shared__ int s_warp_skips[kThreads / 32];

  const int* d_start = desc;
  const int* d_valid = desc + nf_pad;
  const int* d_uniq = desc + 2 * static_cast<size_t>(nf_pad);
  const int* d_blk = desc + 3 * static_cast<size_t>(nf_pad);
  const int* d_first = desc + 4 * static_cast<size_t>(nf_pad);
  const int* d_last = desc + 5 * static_cast<size_t>(nf_pad);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col0 = blockIdx.x * bt;
  float* my_v = board_v + static_cast<size_t>(blockIdx.y) * k * n_cols;
  int* my_g = board_g + static_cast<size_t>(blockIdx.y) * k * n_cols;

  for (int i = tid; i < k * bt; i += kThreads) {
    const int gcol = col0 + i % bt;
    if (gcol < n_cols) {
      my_v[static_cast<size_t>(i / bt) * n_cols + gcol] = -FLT_MAX;
      my_g[static_cast<size_t>(i / bt) * n_cols + gcol] = -1;
    }
  }

  const long long f0 = static_cast<long long>(blockIdx.y) * frags_per_cta;
  const int f1 = static_cast<int>(
      f0 + frags_per_cta < nf_pad ? f0 + frags_per_cta : nf_pad);
  if (tid == 0) s_lead = f1;
  __syncthreads();
  for (long long f = f0 + tid; f < f1; f += kThreads) {
    if (d_first[f]) {
      atomicMin(&s_lead, static_cast<int>(f));
      break;
    }
  }
  __syncthreads();

  int n_skipped = 0;  // real fragments of skipped spans this thread counted
  int f = s_lead;
  while (f < f1) {
    if constexpr (kPruned) {
      // decide the whole span now, against this CTA's own board
      const float* brow = bounds + static_cast<size_t>(d_blk[f]) * n_cols;
      int dead = 1;
      for (int c = tid; c < bt; c += kThreads) {
        const int gcol = col0 + c;
        if (gcol < n_cols
            && !(brow[gcol] < my_v[static_cast<size_t>(k - 1) * n_cols
                                   + gcol])) {
          dead = 0;
        }
      }
      if (__syncthreads_and(dead)) {
        const int e = span_end(d_last, f, nf_pad, &s_end);
        for (int g = f + tid; g <= e; g += kThreads) {
          n_skipped += d_valid[g] > 0;
        }
        f = e + 1;
        if (f >= f1 || !d_first[f]) break;  // next span is another CTA's
        continue;
      }
    }
    for (int i = tid; i < block_size * ld; i += kThreads) acc[i] = 0.f;
    const long long base = static_cast<long long>(d_blk[f]) * block_size;
    __syncthreads();
    for (;;) {  // the span's fragments, in table order
      const int start = d_start[f];
      const int n = d_valid[f] * bt;
      const size_t wrow = static_cast<size_t>(d_uniq[f]) * n_cols;
      // a fragment's docs are distinct, so each element is added at most
      // once here: a thread issues all its loads (kInFlight (posting,
      // column) pairs) before its adds
      for (int i0 = tid; i0 < n; i0 += kInFlight * kThreads) {
        int slot[kInFlight];
        float sv[kInFlight], wv[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int i = i0 + u * kThreads;
          slot[u] = -1;
          if (i < n && col0 + i % bt < n_cols) {
            const int j = start + i / bt;
            const long long row = doc_res[j] - base;
            if (row >= 0 && row < block_size) {
              slot[u] = static_cast<int>(row) * ld + i % bt;
              sv[u] = sc_res[j];
              wv[u] = w[wrow + col0 + i % bt];
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (slot[u] >= 0) {
            acc[slot[u]] = __fadd_rn(acc[slot[u]], __fmul_rn(sv[u], wv[u]));
          }
        }
      }
      __syncthreads();
      if (d_last[f] || f + 1 >= nf_pad) break;
      ++f;
    }

    // block padding past n_docs: the floor score and id -1
    for (int i = tid; i < block_size * ld; i += kThreads) {
      if (base + i / ld >= n_docs) acc[i] = -FLT_MAX;
    }
    __syncthreads();

    // fold the span into this CTA's board, one column per warp
    for (int cc = warp; cc < bt; cc += kThreads / 32) {
      const int gcol = col0 + cc;
      if (gcol >= n_cols) continue;  // warp-uniform
      float* colp = acc + cc;
      auto id_of = [base, n_docs](int row) {
        return base + row < n_docs ? static_cast<int>(base + row) : -1;
      };
      int h = 0;  // head of the sorted board
      for (int r = 0; r < k; ++r) {
        float v;
        int g, pos;
        bm25::column_best(colp, ld, block_size, id_of, lane, v, g, pos);
        const float hv = my_v[static_cast<size_t>(h) * n_cols + gcol];
        const int hg = my_g[static_cast<size_t>(h) * n_cols + gcol];
        if (bm25::rank_before(v, g, hv, hg)) {
          bm25::column_take(colp, ld, pos, lane);
        } else {
          v = hv;
          g = hg;
          ++h;
        }
        if (lane == 0) {
          st_v[r * bt + cc] = v;
          st_g[r * bt + cc] = v == -FLT_MAX ? -1 : g;
        }
        __syncwarp();
      }
      for (int r = lane; r < k; r += 32) {
        my_v[static_cast<size_t>(r) * n_cols + gcol] = st_v[r * bt + cc];
        my_g[static_cast<size_t>(r) * n_cols + gcol] = st_g[r * bt + cc];
      }
      __syncwarp();
    }
    __syncthreads();
    ++f;
    if (f >= f1 || !d_first[f]) break;  // next span is another CTA's
  }

  if constexpr (kPruned) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      n_skipped += __shfl_xor_sync(0xffffffffu, n_skipped, off);
    }
    if (lane == 0) s_warp_skips[warp] = n_skipped;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int i = 0; i < kThreads / 32; ++i) total += s_warp_skips[i];
      skips[static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x] = total;
    }
  }
}

}  // namespace

// Dynamic shared memory of the scoring kernel, in bytes.
extern "C" long long bm25_resident_topk_smem(int block_size, int k, int bt) {
  return (static_cast<long long>(block_size) * (bt + 1)
          + 2LL * static_cast<long long>(k) * bt) * 4;
}

namespace {

// Launch the scoring kernel and the board merge on `stream`; returns the
// CUDA error code (0 = ok).
template <bool kPruned>
int launch_resident(const void* desc, int nf_pad, const void* w, int n_cols,
                    const void* bounds, const void* doc_res,
                    const void* sc_res, int block_size, int k,
                    long long n_docs, int n_boards, int frags_per_cta,
                    int bt, void* board_v, void* board_g, void* skips,
                    void* out_v, void* out_g, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long smem = bm25_resident_topk_smem(block_size, k, bt);
  cudaError_t err = cudaFuncSetAttribute(
      resident_topk_kernel<kPruned>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + bt - 1) / bt, n_boards);
  resident_topk_kernel<kPruned>
      <<<grid, kThreads, static_cast<size_t>(smem), s>>>(
          static_cast<const int*>(desc), nf_pad,
          static_cast<const float*>(w), n_cols,
          static_cast<const int*>(doc_res),
          static_cast<const float*>(sc_res), block_size, k, n_docs,
          frags_per_cta, bt, static_cast<const float*>(bounds),
          static_cast<float*>(board_v), static_cast<int*>(board_g),
          static_cast<int*>(skips));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(bm25::launch_board_merge(
      static_cast<const float*>(board_v), static_cast<const int*>(board_g),
      n_boards, k, n_cols, static_cast<float*>(out_v),
      static_cast<int*>(out_g), s));
}

}  // namespace

// K1. board_v / board_g are [n_boards, k, n_cols] scratch, out_* are
// [k, n_cols].
extern "C" int bm25_resident_topk_launch(
    const void* desc, int nf_pad, const void* w, int n_cols,
    const void* doc_res, const void* sc_res, int block_size, int k,
    long long n_docs, int n_boards, int frags_per_cta, int bt,
    void* board_v, void* board_g, void* out_v, void* out_g, void* stream) {
  return launch_resident<false>(desc, nf_pad, w, n_cols, nullptr, doc_res,
                                sc_res, block_size, k, n_docs, n_boards,
                                frags_per_cta, bt, board_v, board_g, nullptr,
                                out_v, out_g, stream);
}

// K3. bounds is [nb, n_cols] f32, one row per block (every block the
// table names); skips is [n_boards * n_tiles] int32,
// one count of skipped real fragments per CTA.
extern "C" int bm25_resident_pruned_launch(
    const void* desc, int nf_pad, const void* w, int n_cols,
    const void* bounds, const void* doc_res, const void* sc_res,
    int block_size, int k, long long n_docs, int n_boards,
    int frags_per_cta, int bt, void* board_v, void* board_g, void* skips,
    void* out_v, void* out_g, void* stream) {
  return launch_resident<true>(desc, nf_pad, w, n_cols, bounds, doc_res,
                               sc_res, block_size, k, n_docs, n_boards,
                               frags_per_cta, bt, board_v, board_g, skips,
                               out_v, out_g, stream);
}
