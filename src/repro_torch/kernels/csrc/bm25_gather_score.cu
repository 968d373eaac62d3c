// K4: host-gathered candidate chunks -> score -> per-chunk top-k with
// global doc ids, and (two-level) the fold of the chunk winners into one
// [k, B] board.
//
// Replaces: src/repro/kernels/bm25_gather_score.py::bm25_gather_score_topk
// (bodies _gather_kernel and _gather_kernel_shard with _score_tile,
// select_topk and _fold_winners; pallas_call at bm25_gather_score.py:217
// for two_level=True and :238 for the per-chunk output).
//
// What it computes. The operands are the GatheredPostings layout of
// repro_torch.sparse.block_csr.gather_posting_runs: chunk c holds
// acc_block candidate slots whose global doc ids are cand[c, r] (sorted
// ascending, -1 = padding slot) and p_pad token-sorted postings (token,
// slot, score; token -1 = padding). Per chunk c and query column b:
//   acc[r, b] = sum over postings p of chunk c, in posting order, whose
//               token sits at row u of the sorted unique table, of
//               fl(score[p] * w[u, b]) into row r = slot[p];
//   rows whose cand[c, r] < 0 are set to -FLT_MAX;
//   out[c, i, b] = the i-th entry of the column in (score desc, id asc)
//               order, with its id cand[c, row] (-1 for a padding slot).
// Candidates are sorted, so slot order is id order. With two_level the
// [nc, k, B] chunk boards are merged into one [k, B] board in the same
// launch function (board_merge.cuh): the top-k of a union is the top-k of
// its parts' top-ks, so it is the board the TPU's sequential fold builds.
//
// Bound on the H100: every (matched posting, query column) pair costs one
// FP32 multiply and one add (2 operations against 67 TFLOP/s); every
// posting slot is read once (12 bytes against 3.35 TB/s), the candidate
// table once (4 bytes a slot), and the boards written once. At B = 256
// the operations term is the larger; the shared-memory read-modify-write
// of the accumulator is the practical limit of this first version, as in
// K2.
//
// Design: K2's, because a chunk is K2's block with candidate slots for
// document rows.
// * Grid (B-tile of 32 columns, chunk). Each CTA holds a [acc_block, 32]
//   accumulator in shared memory, rows padded to 33 words.
// * The scatter is block_scatter.cuh: each posting's token is
//   binary-searched in the shared unique table, matched postings are
//   staged by owning warp with ballots, each element has one writer and
//   sums in posting order with __fmul_rn / __fadd_rn. No atomics.
// * Two differences from K2: the padding mask comes from the candidate
//   table (the TPU's _reduce at bm25_gather_score.py:111-127), not from
//   n_docs, and the winner ids are global, cand[c, row] (a padding
//   winner's is -1, as in _fold_winners).
// * The TPU's two-level variant folds chunk after chunk through its
//   sequential grid. The card has none, so the chunk boards go to device
//   memory and the board merge of K1 (board_merge.cuh) folds them.
#include "block_scatter.cuh"
#include "board_merge.cuh"
#include "select_topk.cuh"

namespace {

constexpr int kThreads = bm25::kScatterThreads;
constexpr int kWarps = bm25::kScatterWarps;
constexpr int kCols = bm25::kScatterCols;
constexpr int kLd = bm25::kScatterLd;

__global__ void __launch_bounds__(kThreads) gather_score_topk_kernel(
    const int* __restrict__ tok, const int* __restrict__ slot,
    const float* __restrict__ sc, int p_pad, const int* __restrict__ uniq,
    int n_uniq, const float* __restrict__ w, int n_cols,
    const int* __restrict__ cand, int acc_block, int k,
    float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [acc_block * kLd]
  int* cand_s = reinterpret_cast<int*>(
      acc + static_cast<size_t>(acc_block) * kLd);      // [acc_block]
  int* uniq_s = cand_s + acc_block;                     // [n_uniq]
  unsigned char* staging = reinterpret_cast<unsigned char*>(uniq_s + n_uniq);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long c = blockIdx.y;

  for (int i = tid; i < acc_block * kLd; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < acc_block; i += kThreads) {
    cand_s[i] = cand[static_cast<size_t>(c) * acc_block + i];
  }
  for (int i = tid; i < n_uniq; i += kThreads) uniq_s[i] = uniq[i];
  __syncthreads();

  const size_t row_base = static_cast<size_t>(c) * p_pad;
  bm25::scatter_block_postings(tok + row_base, slot + row_base,
                               sc + row_base, p_pad, uniq_s, n_uniq, w,
                               n_cols, blockIdx.x * kCols, acc_block, acc,
                               staging);

  // padding slots (no candidate document) must not outrank real negative
  // scores (robertson IDF): mask them to the floor first
  for (int i = tid; i < acc_block * kLd; i += kThreads) {
    if (cand_s[i / kLd] < 0) acc[i] = -FLT_MAX;
  }
  __syncthreads();

  for (int cc = warp; cc < kCols; cc += kWarps) {
    const int gcol = blockIdx.x * kCols + cc;
    if (gcol >= n_cols) continue;  // warp-uniform
    float* colp = acc + cc;
    for (int r = 0; r < k; ++r) {
      float v;
      int g, pos;
      bm25::column_best(colp, kLd, acc_block,
                        [cand_s](int row) { return cand_s[row]; }, lane, v,
                        g, pos);
      bm25::column_take(colp, kLd, pos, lane);
      if (lane == 0) {
        const size_t o = (static_cast<size_t>(c) * k + r) * n_cols + gcol;
        out_v[o] = v;
        out_i[o] = g;
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Dynamic shared memory of the scoring kernel, in bytes.
extern "C" long long bm25_gather_score_topk_smem(int acc_block, int n_uniq) {
  return static_cast<long long>(acc_block) * kLd * 4
         + static_cast<long long>(acc_block) * 4
         + static_cast<long long>(n_uniq) * 4 + bm25::kScatterStagingBytes;
}

// Launch on `stream`; returns the CUDA error code (0 on success).
// out_v / out_i are the [n_chunks, k, n_cols] chunk boards; with
// two_level != 0 they are scratch and the merged [k, n_cols] board goes to
// fold_v / fold_i.
extern "C" int bm25_gather_score_topk_launch(
    const void* tok, const void* slot, const void* sc, int n_chunks,
    int p_pad, const void* uniq, int n_uniq, const void* w, int n_cols,
    const void* cand, int acc_block, int k, void* out_v, void* out_i,
    int two_level, void* fold_v, void* fold_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long smem = bm25_gather_score_topk_smem(acc_block, n_uniq);
  cudaError_t err = cudaFuncSetAttribute(
      gather_score_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + kCols - 1) / kCols, n_chunks);
  gather_score_topk_kernel<<<grid, kThreads, static_cast<size_t>(smem), s>>>(
      static_cast<const int*>(tok), static_cast<const int*>(slot),
      static_cast<const float*>(sc), p_pad, static_cast<const int*>(uniq),
      n_uniq, static_cast<const float*>(w), n_cols,
      static_cast<const int*>(cand), acc_block, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  err = cudaGetLastError();
  if (err != cudaSuccess || !two_level) return static_cast<int>(err);
  return static_cast<int>(bm25::launch_board_merge(
      static_cast<const float*>(out_v), static_cast<const int*>(out_i),
      n_chunks, k, n_cols, static_cast<float*>(fold_v),
      static_cast<int*>(fold_i), s));
}
