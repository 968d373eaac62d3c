// K2: fused full-scan score -> per-block top-k over block-bucketed postings,
// and K6: the same scan's dense per-block scores.
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
// K6 is K2's kernel without the padding mask and the selection, as the
// reference's _kernel has neither (ops.bm25_score_blocked slices the
// padded documents off). What it computes: out[i, d, b] = acc[d, b] of
// block i, for every row d < block_size. Bound on the H100: K2's
// operations and posting reads plus the dense output, nb * block_size * B
// floats written once against 3.35 TB/s; at full width the write
// dominates the bytes. The TPU's [PT, U] compare-count and one-hot MXU
// matmul are not carried over: block_scatter.cuh computes the same sums.
// After the scatter each warp writes its own rows (row % 8 == warp), a
// lane per column: out[blk, row, col0 .. col0 + 31] is 128 contiguous
// bytes, one coalesced store per row.

#include "block_scatter.cuh"
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

__global__ void __launch_bounds__(kThreads) block_score_kernel(
    const int* __restrict__ tok, const int* __restrict__ loc,
    const float* __restrict__ sc, int p_pad, const int* __restrict__ uniq,
    int n_uniq, const float* __restrict__ w, int n_cols, int block_size,
    float* __restrict__ out) {
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

  const int gcol = blockIdx.x * kCols + lane;
  if (gcol < n_cols) {
    for (int r = warp; r < block_size; r += kWarps) {
      out[(static_cast<size_t>(blk) * block_size + r) * n_cols + gcol] =
          acc[r * kLd + lane];
    }
  }
}

}  // namespace

// Dynamic shared memory either kernel needs, in bytes (the same layout).
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

// Launch K6 on `stream`; returns the CUDA error code (0 on success).
extern "C" int bm25_block_score_launch(
    const void* tok, const void* loc, const void* sc, int n_blocks,
    int p_pad, const void* uniq, int n_uniq, const void* w, int n_cols,
    int block_size, void* out, void* stream) {
  const long long smem = bm25_block_score_smem(block_size, n_uniq);
  cudaError_t err = cudaFuncSetAttribute(
      block_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + kCols - 1) / kCols, n_blocks);
  block_score_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<const int*>(loc),
      static_cast<const float*>(sc), p_pad, static_cast<const int*>(uniq),
      n_uniq, static_cast<const float*>(w), n_cols, block_size,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
