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
// Real candidates ascend with the slot and padding slots follow them, so
// the kernel ranks ties by slot, which is id order. With two_level the
// [nc, k, B] chunk boards are merged into one [k, B] board in the same
// launch function (board_merge.cuh): the top-k of a union is the top-k of
// its parts' top-ks, so it is the board the TPU's sequential fold builds.
//
// Bound on the H100: every (matched posting, query column) pair costs one
// FP32 multiply and one add (2 operations against 67 TFLOP/s); the token
// of every posting slot (4 bytes) and the slot and score of every real
// posting (8 bytes) are read once against 3.35 TB/s, the candidate table
// once (4 bytes a slot), and the boards written once. At B = 256
// the operations term is the larger (0.172 ms at shard 0's host-rung
// shapes); in practice the owner rounds' shared-memory traffic limits
// it, as in K2, K6 and K1.
//
// K4's first version (24.5 ms at shard 0's host-rung shapes on an H100
// 80GB HBM3 at 700 W) was K2's first template: eight CTAs of 32 columns
// a chunk, each re-reading every posting and binary-searching its token
// in a shared copy of the unique table, then k rounds a column. Its
// shared copy of the table sat beside a [acc_block, 33] accumulator, so
// it refused wide tables (U past ~40 k at acc_block 512).
//
// Design: K2's, because a chunk is K2's block with candidate slots for
// document rows; the body is block_topk.cuh (gather_score_topk_kernel).
// * One CTA of 16 warps a (chunk, 64 query columns). The chunk's postings
//   are token-sorted (gather_posting_runs builds them with
//   block_postings_from_coo), so block_walk.cuh's run search applies:
//   each table row is searched once in the chunk's tokens, only matched
//   postings are read, and rounds of 2,048 are added by owner warp in
//   posting order (owner_round.cuh), with __fmul_rn then __fadd_rn. No
//   atomics: bitwise the twin's sums.
//   Any U; acc_block past 512 rows is walked in windows of 512.
// * The padding mask comes from the candidate table (the TPU's _reduce
//   at bm25_gather_score.py:111-127), not from n_docs, and the written
//   ids are global, cand[c, slot] (a padding winner's is -1, as in
//   _fold_winners).
// * The fold is K2's (threshold_fold.cuh, shared with K1/K3): a chunk of
//   at most 512 slots (the host rung's at k <= 512) takes fold_select,
//   128 board rows a pass; a wider chunk merges window by window into a
//   device-memory board.
// * The TPU's two-level variant folds chunk after chunk through its
//   sequential grid. The card has none, so the chunk boards go to device
//   memory and the board merge of K1 (board_merge.cuh) folds them.
#include "block_topk.cuh"
#include "board_merge.cuh"

namespace {

constexpr int kThreads = bm25::kRoundThreads;
constexpr int kWarps = bm25::kRoundWarps;
constexpr int kCols = bm25::kRoundCols;

__global__ void __launch_bounds__(kThreads, 1) gather_score_topk_kernel(
    const int* __restrict__ tok, const int* __restrict__ slot,
    const float* __restrict__ sc, int p_pad, const int* __restrict__ uniq,
    int n_uniq, const float* __restrict__ w, int n_cols,
    const int* __restrict__ cand, int acc_block, int k,
    float* __restrict__ out_v, int* __restrict__ out_i, float* board_v,
    int* board_g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long s_scan[kWarps];
  __shared__ int s_seg[kWarps + 1];
  bm25::block_topk<true>(tok, slot, sc, p_pad, uniq, n_uniq, w, n_cols,
                         acc_block, k, 0, cand, out_v, out_i, board_v,
                         board_g, smem_raw, s_scan, s_seg);
}

}  // namespace

// Does the scoring kernel at acc_block need the device-memory board
// scratch ([n_chunks, n_cols, k] f32 values and i32 slots)? 1 if so.
extern "C" int bm25_gather_score_topk_scratch(int acc_block) {
  return bm25::block_topk_selects(acc_block) ? 0 : 1;
}

// Launch on `stream`; returns the CUDA error code (0 on success).
// out_v / out_i are the [n_chunks, k, n_cols] chunk boards; with
// two_level != 0 they are scratch and the merged [k, n_cols] board goes to
// fold_v / fold_i. board_v / board_g: the board scratch, or null when
// bm25_gather_score_topk_scratch says none is needed.
extern "C" int bm25_gather_score_topk_launch(
    const void* tok, const void* slot, const void* sc, int n_chunks,
    int p_pad, const void* uniq, int n_uniq, const void* w, int n_cols,
    const void* cand, int acc_block, int k, void* out_v, void* out_i,
    int two_level, void* fold_v, void* fold_i, void* board_v,
    void* board_g, void* stream) {
  if (k < 1 || k > acc_block
      || (board_v == nullptr) != bm25::block_topk_selects(acc_block))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long smem = bm25::block_topk_smem(acc_block);  // any U
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
      static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<float*>(board_v), static_cast<int*>(board_g));
  err = cudaGetLastError();
  if (err != cudaSuccess || !two_level) return static_cast<int>(err);
  return static_cast<int>(bm25::launch_board_merge(
      static_cast<const float*>(out_v), static_cast<const int*>(out_i),
      n_chunks, k, n_cols, static_cast<float*>(fold_v),
      static_cast<int*>(fold_i), s));
}
