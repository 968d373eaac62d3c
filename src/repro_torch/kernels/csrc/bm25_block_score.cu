// K2: fused full-scan score -> per-block top-k over block-bucketed postings.
//
// Replaces: src/repro/kernels/bm25_block_score.py::bm25_block_score_topk
// (_fused_kernel, _score_tile; pallas_call at bm25_block_score.py:206).
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
// * Postings within a block are token-sorted and several hit the same
//   document, so threads over postings would collide. Instead a chunk of
//   256 postings is read one a thread; each thread binary-searches its
//   posting's token in the shared unique table, and the matched postings
//   are staged in shared memory partitioned by owning warp (warp w owns
//   rows r with r % 8 == w), stably, with ballots. Each warp then walks
//   only its own entries in posting order, a lane per query column. Each
//   accumulator element therefore has exactly one writer and a fixed
//   summation order: no atomics, bitwise equal to the twin.
// * Products and sums are __fmul_rn then __fadd_rn: nvcc would otherwise
//   contract acc + s * w into one FMA, which rounds once where the twin
//   rounds twice.
// * Selection is the shared select_topk.cuh (a warp per column).

#include "select_topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // = row owners; the scan assumes 8
constexpr int kCols = 32;              // query columns a CTA (a lane each)
constexpr int kLd = kCols + 1;         // acc row stride: a column's rows
                                       // fall in distinct shared banks
constexpr int kChunk = kThreads;       // postings read per round

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
  int* e_row = uniq_s + n_uniq;                         // [kChunk]
  int* e_loc = e_row + kChunk;                          // [kChunk]
  float* e_sc = reinterpret_cast<float*>(e_loc + kChunk);  // [kChunk]
  // matched counts and staging offsets, [owner * kWarps + warp]
  __shared__ int s_cnt[kWarps * kWarps];
  __shared__ int s_off[kWarps * kWarps];
  __shared__ int s_end[kWarps];          // end of each owner's entries

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = blockIdx.x * kCols + lane;
  const long long blk = blockIdx.y;

  for (int i = tid; i < block_size * kLd; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < n_uniq; i += kThreads) uniq_s[i] = uniq[i];
  __syncthreads();

  const size_t row_base = static_cast<size_t>(blk) * p_pad;
  for (int base = 0; base < p_pad; base += kChunk) {
    const int p = base + tid;
    int t = -1, l = 0, r = -1;
    float s = 0.f;
    if (p < p_pad) {
      t = tok[row_base + p];
      l = loc[row_base + p];
      s = sc[row_base + p];
    }
    if (t >= 0 && static_cast<unsigned>(l) < static_cast<unsigned>(block_size)) {
      int lo = 0, hi = n_uniq;  // lower bound of t in the sorted table
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (uniq_s[mid] < t) lo = mid + 1; else hi = mid;
      }
      if (lo < n_uniq && uniq_s[lo] == t) r = lo;
    }
    // stable partition of the matched postings by owner warp (l % 8)
    const int owner = r >= 0 ? (l & (kWarps - 1)) : -1;
    int rank = 0;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const unsigned m = __ballot_sync(0xffffffffu, owner == q);
      if (lane == 0) s_cnt[q * kWarps + warp] = __popc(m);
      if (owner == q) rank = __popc(m & ((1u << lane) - 1u));
    }
    if (!__syncthreads_or(owner >= 0)) continue;  // nothing matched
    if (warp == 0) {  // exclusive scan of the 64 counts, two a lane
      const int c0 = s_cnt[2 * lane], c1 = s_cnt[2 * lane + 1];
      int x = c0 + c1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
      }
      s_off[2 * lane] = x - c0 - c1;
      s_off[2 * lane + 1] = x - c1;
      if ((lane & 3) == 3) s_end[lane >> 2] = x;  // owner lane/4 ends here
    }
    __syncthreads();
    if (owner >= 0) {
      const int e = s_off[owner * kWarps + warp] + rank;
      e_row[e] = r;
      e_loc[e] = l;
      e_sc[e] = s;
    }
    __syncthreads();
    if (col < n_cols) {
      const int e1 = s_end[warp];
#pragma unroll 4
      for (int e = warp == 0 ? 0 : s_end[warp - 1]; e < e1; ++e) {
        const float prod = __fmul_rn(
            e_sc[e], w[static_cast<size_t>(e_row[e]) * n_cols + col]);
        float* a = acc + static_cast<size_t>(e_loc[e]) * kLd + lane;
        *a = __fadd_rn(*a, prod);
      }
    }
    __syncthreads();
  }

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

}  // namespace

// Dynamic shared memory the kernel needs, in bytes.
extern "C" long long bm25_block_score_topk_smem(int block_size, int n_uniq) {
  return static_cast<long long>(block_size) * kLd * 4
         + static_cast<long long>(n_uniq) * 4 + 3LL * kChunk * 4;
}

// Launch on `stream`; returns the CUDA error code (0 on success).
extern "C" int bm25_block_score_topk_launch(
    const void* tok, const void* loc, const void* sc, int n_blocks,
    int p_pad, const void* uniq, int n_uniq, const void* w, int n_cols,
    int block_size, int k, long long n_docs, void* out_v, void* out_i,
    void* stream) {
  const long long smem = bm25_block_score_topk_smem(block_size, n_uniq);
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
