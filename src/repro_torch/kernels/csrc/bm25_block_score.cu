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
// the card's 67 TFLOP/s); the bytes are the token of every posting slot
// (4 bytes: the walk reads the rest of a posting only where its token is
// in the table), the row and score of each matched posting (8 bytes), the
// tables and the [nb, k, B] board written once, against 3.35 TB/s; for a
// dense batch the bytes are the larger term. The practical limit is the
// owner rounds' shared-memory traffic, as in K6 and K1.
//
// K2's first version (80.2 ms at the full-width retriever's shapes on an
// H100 80GB HBM3 at 700 W) was eight CTAs of 32 columns a block, each
// re-reading every posting and binary-searching its token in a shared
// copy of the unique table, three barriers every 256 postings, a global
// weight read a matched posting, then k rounds a column of a full scan,
// a butterfly and a dependent pass a winner. K6 lost the same scatter
// (50.9 -> 25.7 ms) and K1 the same k rounds (263.2 -> 25.3 ms).
//
// K2's design (block_score_topk_kernel): K6's CTA and walk, then K1's
// fold. block_topk.cuh holds the body, shared with K4:
// * one CTA of 16 warps a (block, 64 query columns), two columns a lane;
//   the walk of block_walk.cuh (shared with K6: runs matched once, rounds
//   of 2,048 postings partitioned by owner warp, the any-order fallback)
//   into a [512, 64] shared accumulator, a window of 512 rows at a time
//   (blocks of more than 512 rows take more windows; K2 takes any
//   block_size and any U);
// * rows of documents >= n_docs take -FLT_MAX (so padding rows are still
//   taken, in row order, when a block holds fewer than k real documents),
//   and the window folds by threshold_fold.cuh (shared with K1/K3). A
//   block of one window (at most 512 rows; the main path's 512) takes
//   fold_select: each column's k-th key by a bitwise search of counts, the
//   rows above it ranked by count, the rows at it in row order, 128 board
//   rows a pass (k = 100 in one), each pass staged as a [kp, 64] board
//   over the accumulator and written out coalesced. Blocks of more windows
//   merge each window's rows that beat the board's row k - 1 into a
//   device-memory board (K1's fold; exact, but a chain of dependent
//   shuffles a chunk of 32 candidates: with every block's first window
//   merged into an empty board, K2 took 93.2 ms at k = 100 against 32.4
//   at k = 1).
// No float atomics: each sum has one writer in posting order, with
// __fmul_rn then __fadd_rn, so the sums are the twin's bit for bit, and
// the board is the twin's (score desc, row asc) order.
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
// accumulator in shared memory (128 KB at 512 rows, one CTA an SM); the
// walk (the four points below) is block_walk.cuh, shared with K2 and K4:
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

#include "block_topk.cuh"
#include "block_walk.cuh"

namespace {

constexpr int kThreads = bm25::kRoundThreads;
constexpr int kWarps = bm25::kRoundWarps;   // row owners: row % 16
constexpr int kCols = bm25::kRoundCols;     // query columns a CTA

// -- K2 ------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1) block_score_topk_kernel(
    const int* __restrict__ tok, const int* __restrict__ loc,
    const float* __restrict__ sc, int p_pad, const int* __restrict__ uniq,
    int n_uniq, const float* __restrict__ w, int n_cols, int block_size,
    int k, long long n_docs, float* __restrict__ out_v,
    int* __restrict__ out_i, float* board_v, int* board_g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long s_scan[kWarps];
  __shared__ int s_seg[kWarps + 1];
  bm25::block_topk<false>(tok, loc, sc, p_pad, uniq, n_uniq, w, n_cols,
                          block_size, k, n_docs, nullptr, out_v, out_i,
                          board_v, board_g, smem_raw, s_scan, s_seg);
}

// -- K6 ------------------------------------------------------------------

// The sum's f32 value stored as T: a float as it is; bf16 rounded once,
// to nearest even (torch's float -> bfloat16 cast).
__device__ __forceinline__ void store_as(float* o, float v) { *o = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// T: the scores', the weights' and the output's element, float or bf16.
// The bf16 instantiation widens each score and weight exactly as it reads
// them, forms each product in f32 (exact for bf16 x bf16: 16 significant
// bits of 24), sums in the f32 kernel's order and rounds once at the
// store: its output is bf16(K6_f32(widen(scores), widen(weights))).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) dense_score_kernel(
    const int* __restrict__ tok, const int* __restrict__ loc,
    const T* __restrict__ sc, int p_pad, const int* __restrict__ uniq,
    int n_uniq, const T* __restrict__ w, int n_cols, int block_size,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long s_scan[kWarps];
  __shared__ int s_seg[kWarps + 1];
  const bm25::WalkSmem s = bm25::walk_carve(smem_raw, block_size, s_scan,
                                            s_seg);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long blk = blockIdx.y;
  const int col0 = blockIdx.x * kCols;
  const int* tb = tok + blk * p_pad;

  float4* acc4 = reinterpret_cast<float4*>(s.acc);
  for (int i = tid; i < block_size * (kCols / 4); i += kThreads)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the owner counts start at zero (and are zeroed again during each walk)
  for (int i = tid; i < bm25::kRoundCounts; i += kThreads) s.counts[i] = 0;
  int n_real;
  const bool sorted = bm25::tokens_ascend(tb, p_pad, s_scan, n_real);
  bm25::walk_block(tb, loc + blk * p_pad, sc + blk * p_pad, p_pad, n_real,
                   sorted, uniq, n_uniq, w, n_cols, col0, 0, block_size, s);
  __syncthreads();

  // every row written, a lane per column: 128 contiguous bytes a store
  for (int row = warp; row < block_size; row += kWarps) {
    T* o = out + (blk * block_size + row) * n_cols + col0;
#pragma unroll
    for (int h = 0; h < kCols; h += 32) {
      if (col0 + h + lane < n_cols)
        store_as(o + h + lane, s.acc[row * kCols + h + lane]);
    }
  }
}

}  // namespace

// Does K2 at block_size need the device-memory board scratch
// ([n_blocks, n_cols, k] f32 values and i32 rows)? 1 if so.
extern "C" int bm25_block_score_topk_scratch(int block_size) {
  return bm25::block_topk_selects(block_size) ? 0 : 1;
}

// Launch K2 on `stream`; returns the CUDA error code (0 on success).
// board_v / board_g: the board scratch, or null when
// bm25_block_score_topk_scratch says none is needed.
extern "C" int bm25_block_score_topk_launch(
    const void* tok, const void* loc, const void* sc, int n_blocks,
    int p_pad, const void* uniq, int n_uniq, const void* w, int n_cols,
    int block_size, int k, long long n_docs, void* out_v, void* out_i,
    void* board_v, void* board_g, void* stream) {
  if (k < 1 || k > block_size
      || (board_v == nullptr) != bm25::block_topk_selects(block_size))
    return static_cast<int>(cudaErrorInvalidValue);
  // any U; blocks of more than 512 rows are walked 512 rows at a time
  const long long smem = bm25::block_topk_smem(block_size);
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
      static_cast<float*>(out_v), static_cast<int*>(out_i),
      static_cast<float*>(board_v), static_cast<int*>(board_g));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory K6 needs, in bytes: the [block_size, 64]
// accumulator, the staged postings, weight rows and owner counts, and the
// run table of one piece of the unique table (any number of table rows).
extern "C" long long bm25_block_score_dense_smem(int block_size) {
  return static_cast<long long>(block_size) * kCols * 4
         + bm25::kWalkScratchBytes;
}

namespace {

template <typename T>
int dense_launch(const void* tok, const void* loc, const void* sc,
                 int n_blocks, int p_pad, const void* uniq, int n_uniq,
                 const void* w, int n_cols, int block_size, void* out,
                 void* stream) {
  const long long smem = bm25_block_score_dense_smem(block_size);
  cudaError_t err = cudaFuncSetAttribute(
      dense_score_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_cols + kCols - 1) / kCols, n_blocks);
  dense_score_kernel<T><<<grid, kThreads, static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tok), static_cast<const int*>(loc),
      static_cast<const T*>(sc), p_pad, static_cast<const int*>(uniq),
      n_uniq, static_cast<const T*>(w), n_cols, block_size,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch K6 on `stream`; returns the CUDA error code (0 on success).
extern "C" int bm25_block_score_launch(
    const void* tok, const void* loc, const void* sc, int n_blocks,
    int p_pad, const void* uniq, int n_uniq, const void* w, int n_cols,
    int block_size, void* out, void* stream) {
  return dense_launch<float>(tok, loc, sc, n_blocks, p_pad, uniq, n_uniq, w,
                             n_cols, block_size, out, stream);
}

// K6's bf16 instantiation: bf16 scores, weights and output, the same
// grid, shared memory and walk.
extern "C" int bm25_block_score_bf16_launch(
    const void* tok, const void* loc, const void* sc, int n_blocks,
    int p_pad, const void* uniq, int n_uniq, const void* w, int n_cols,
    int block_size, void* out, void* stream) {
  return dense_launch<__nv_bfloat16>(tok, loc, sc, n_blocks, p_pad, uniq,
                                     n_uniq, w, n_cols, block_size, out,
                                     stream);
}
