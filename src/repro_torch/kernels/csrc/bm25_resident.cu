// K1: resident gather -> score -> top-k over fragment descriptors.
//
// Replaces: src/repro/kernels/bm25_gather_score.py::bm25_resident_score_topk
// (bodies _resident_kernel / _resident_kernel_db with _resident_scatter,
// _resident_fold and _fold_winners; pallas_call at bm25_gather_score.py:661).
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
// the score is the padding value.
//
// Bound on the H100: each gathered posting is read once (8 bytes against
// 3.35 TB/s) and costs one FP32 multiply and one add per query column
// (2 operations against 67 TFLOP/s); at B = 256 the adds dominate. The
// fragment walk is latency-bound in this first version: one barrier per
// fragment, and fragments of Zipf tails hold few postings.
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
//   second kernel below: a warp per column merges the G sorted boards.

#include "select_topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // (posting, column) loads a thread keeps open
constexpr int kMergeWarps = 8;

__global__ void __launch_bounds__(kThreads) resident_topk_kernel(
    const int* __restrict__ desc, int nf_pad, const float* __restrict__ w,
    int n_cols, const int* __restrict__ doc_res,
    const float* __restrict__ sc_res, int block_size, int k,
    long long n_docs, int frags_per_cta, int bt, float* __restrict__ board_v,
    int* __restrict__ board_g) {
  extern __shared__ unsigned char smem_raw[];
  const int ld = bt + 1;  // acc row stride: a column's rows in distinct banks
  float* acc = reinterpret_cast<float*>(smem_raw);  // [block_size * ld]
  float* st_v = acc + static_cast<size_t>(block_size) * ld;  // [k * bt]
  int* st_g = reinterpret_cast<int*>(st_v + static_cast<size_t>(k) * bt);
  __shared__ int s_lead;

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

  int f = s_lead;
  while (f < f1) {
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
}

// Merge the G sorted per-CTA boards [G, k, B] into the [k, B] board.
__global__ void __launch_bounds__(kMergeWarps * 32) board_merge_kernel(
    const float* __restrict__ board_v, const int* __restrict__ board_g,
    int n_boards, int k, int n_cols, float* __restrict__ out_v,
    int* __restrict__ out_g) {
  extern __shared__ int heads[];  // [kMergeWarps * n_boards]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kMergeWarps + warp;
  int* h = heads + static_cast<size_t>(warp) * n_boards;
  for (int l = lane; l < n_boards; l += 32) h[l] = 0;
  __syncwarp();
  if (col >= n_cols) return;  // warp-uniform
  for (int r = 0; r < k; ++r) {
    float v = -INFINITY;
    int g = INT_MAX, p = INT_MAX;
    for (int l = lane; l < n_boards; l += 32) {
      const int hl = h[l];
      if (hl >= k) continue;
      const size_t o = (static_cast<size_t>(l) * k + hl) * n_cols + col;
      const float x = board_v[o];
      const int id = board_g[o];
      if (bm25::rank_before(x, id, v, g)) {
        v = x;
        g = id;
        p = l;
      }
    }
    bm25::warp_best(v, g, p);
    if (lane == (p & 31)) h[p] += 1;
    if (lane == 0) {
      out_v[static_cast<size_t>(r) * n_cols + col] = v;
      out_g[static_cast<size_t>(r) * n_cols + col] = g;
    }
    __syncwarp();
  }
}

}  // namespace

// Dynamic shared memory of the scoring kernel, in bytes.
extern "C" long long bm25_resident_topk_smem(int block_size, int k, int bt) {
  return (static_cast<long long>(block_size) * (bt + 1)
          + 2LL * static_cast<long long>(k) * bt) * 4;
}

// Launch both kernels on `stream`; returns the CUDA error code (0 = ok).
// board_v / board_g are [n_boards, k, n_cols] scratch, out_* are [k, n_cols].
extern "C" int bm25_resident_topk_launch(
    const void* desc, int nf_pad, const void* w, int n_cols,
    const void* doc_res, const void* sc_res, int block_size, int k,
    long long n_docs, int n_boards, int frags_per_cta, int bt,
    void* board_v, void* board_g, void* out_v, void* out_g, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long smem = bm25_resident_topk_smem(block_size, k, bt);
  cudaError_t err = cudaFuncSetAttribute(
      resident_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + bt - 1) / bt, n_boards);
  resident_topk_kernel<<<grid, kThreads, static_cast<size_t>(smem), s>>>(
      static_cast<const int*>(desc), nf_pad, static_cast<const float*>(w),
      n_cols, static_cast<const int*>(doc_res),
      static_cast<const float*>(sc_res), block_size, k, n_docs,
      frags_per_cta, bt, static_cast<float*>(board_v),
      static_cast<int*>(board_g));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t msmem = static_cast<size_t>(kMergeWarps) * n_boards * 4;
  err = cudaFuncSetAttribute(board_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(msmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  board_merge_kernel<<<(n_cols + kMergeWarps - 1) / kMergeWarps,
                       kMergeWarps * 32, msmem, s>>>(
      static_cast<const float*>(board_v), static_cast<const int*>(board_g),
      n_boards, k, n_cols, static_cast<float*>(out_v),
      static_cast<int*>(out_g));
  return static_cast<int>(cudaGetLastError());
}
