// Merge of G sorted [k, B] boards into one, shared by K1/K3 and K4.
//
// Replaces the cross-step winner fold of the TPU kernels, which run their
// grid in order and fold each block's (K1, K3) or chunk's (K4) winners
// into one running [k, B] board (src/repro/kernels/bm25_gather_score.py::
// _fold_winners, _resident_fold, _gather_kernel_shard). The card has no
// sequential grid: the scoring kernels emit G sorted boards [G, k, B],
// and this kernel merges them. The top-k of a union equals the top-k of
// its parts' top-ks, so the board is the fold's, in the port's order
// (score desc, id asc; select_topk.cuh).
//
// Design: a warp per query column keeps a head index into each of the G
// boards (in shared memory) and takes k rounds; each round every lane
// scans the heads of its boards, a butterfly picks the warp-wide best
// (ties on (score, id) go to the lower board), and the winner's head
// advances.
//
// K4's boards are [G, k, B] (row-major); K1/K3's are [G, B, k], each
// column's k rows contiguous, so that a scoring warp reads and rewrites a
// column in coalesced runs. A template flag picks the layout.
//
// Bound: k rounds over G heads per column, k * G * B reads of 8 bytes.
#pragma once

#include "select_topk.cuh"

namespace bm25 {

constexpr int kMergeMaxWarps = 8;   // columns per CTA, at most
constexpr int kMergeSmemLimit = 232448;

// board_v / board_g are [n_boards, k, n_cols] ([n_boards, n_cols, k] with
// kColMajor); out_v / out_g [k, n_cols].
template <bool kColMajor>
__global__ void __launch_bounds__(kMergeMaxWarps * 32) board_merge_kernel(
    const float* __restrict__ board_v, const int* __restrict__ board_g,
    int n_boards, int k, int n_cols, float* __restrict__ out_v,
    int* __restrict__ out_g) {
  extern __shared__ int heads[];  // [warps * n_boards]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * (blockDim.x >> 5) + warp;
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
      const size_t o = kColMajor
          ? (static_cast<size_t>(l) * n_cols + col) * k + hl
          : (static_cast<size_t>(l) * k + hl) * n_cols + col;
      const float x = board_v[o];
      const int id = board_g[o];
      if (rank_before(x, id, v, g)) {
        v = x;
        g = id;
        p = l;
      }
    }
    warp_best(v, g, p);
    if (lane == (p & 31)) h[p] += 1;
    if (lane == 0) {
      out_v[static_cast<size_t>(r) * n_cols + col] = v;
      out_g[static_cast<size_t>(r) * n_cols + col] = g;
    }
    __syncwarp();
  }
}

// Launch the merge on `stream`: as many columns a CTA (at most
// kMergeMaxWarps) as the heads of n_boards boards leave room for in
// shared memory; col_major picks the [n_boards, n_cols, k] layout.
// Returns the CUDA error code (0 = ok); too many boards for one warp's
// heads is cudaErrorInvalidValue (the wrappers check first).
inline cudaError_t launch_board_merge(const float* board_v,
                                      const int* board_g, int n_boards,
                                      int k, int n_cols, float* out_v,
                                      int* out_g, cudaStream_t stream,
                                      bool col_major = false) {
  const long long per_warp = 4LL * n_boards;
  if (per_warp > kMergeSmemLimit) return cudaErrorInvalidValue;
  int warps = static_cast<int>(kMergeSmemLimit / per_warp);
  if (warps > kMergeMaxWarps) warps = kMergeMaxWarps;
  const size_t smem = static_cast<size_t>(warps) * per_warp;
  const auto kern =
      col_major ? board_merge_kernel<true> : board_merge_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<(n_cols + warps - 1) / warps, warps * 32, smem, stream>>>(
      board_v, board_g, n_boards, k, n_cols, out_v, out_g);
  return cudaGetLastError();
}

}  // namespace bm25
