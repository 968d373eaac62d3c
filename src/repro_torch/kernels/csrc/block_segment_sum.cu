// K7: blocked segment sum, the per-block scatter-add of the sparse
// substrate (GNN message aggregation, bag reductions).
//
// Replaces: src/repro/kernels/block_segment_sum.py::block_segment_sum
// (_kernel; pallas_call at block_segment_sum.py:50).
//
// What it computes: for block b of nb, with values [nb, P, D] (f32 or f16)
// and local ids [nb, P] (i32),
//   out[b, s, :] = sum over postings p of block b with ids[b, p] == s, in
//                  posting order, of values[b, p, :]      for s in [0, S).
// An id outside [0, S) adds nothing (a one-hot row of such an id is all
// zeros on the TPU, and the reference oracle, jax.ops.segment_sum, drops
// it); the kernel never writes outside its block. Padding postings carry
// zero values and are read like any other. Sums are taken in f32 and
// rounded once to the output dtype (the TPU accumulates f16 tile by tile
// in the f16 output; the port's f16 sums are closer, within the
// reference test's 2e-2).
//
// Bound on the H100: every value is read once (nb * P * D elements) and
// every output written once; one FP32 add an element is far under the
// card's 67 TFLOP/s, so 3.35 TB/s of device memory bounds it.
//
// Design:
// * The TPU forms one_hot(ids)^T @ values on the MXU, accumulating over
//   P / tile_p tiles in the output block. Here the scatter is direct: one
//   CTA per (block, D-tile, S-range) holds an [S_TILE, D_TILE] f32
//   accumulator in shared memory (128 KB at S = 512, D_TILE = 64) and
//   walks all of the block's postings in order, adding only the ids of
//   its own range [s0, s0 + S_TILE). There is no one-hot product, and no
//   add races another.
// * The wrapper's plan (block_segment_sum.py::column_tile) takes the
//   widest D_TILE whose accumulator holds all S segments (one S-range);
//   past 7,056 segments no tile does even at 8 columns, and S is cut into
//   the fewest equal ranges that fit at D_TILE = 8. Every CTA of a range
//   reads all of the block's postings, so the split costs one more read
//   of the values a range (2 at S = 10,000, 8 at S = 50,000); each
//   element still has one writer adding in posting order, so the result
//   is bitwise the twin's at any S.
// * Thread t owns column t % D_TILE of the segments s0 + r with
//   r % GROUPS == t / D_TILE (GROUPS = 256 / D_TILE): one writer an
//   accumulator element, adding in posting order with __fadd_rn, so the
//   sum order is fixed and equals the twin's serial index_add_ bit for
//   bit. With D_TILE >= 32 a warp holds one group: it ballots the staged
//   ids 32 at a time and adds only its group's postings, in order,
//   keeping the running sum of the current segment in a register while
//   its postings come in a run. Narrower tiles walk every id.
// * A posting whose staged row is all zeros is skipped (adding +-0 never
//   changes a sum that starts at +0 and rounds to nearest, so the result
//   is bit for bit the same). Padding is such a row: at the ogb_products
//   shape two postings in three are padding, all of segment 0, and a
//   first version that added them one after another ran at 6.4x its
//   bound.
// * Postings are staged 128 at a time: all 256 threads load the next
//   [128, D_TILE] tile and its ids into registers (coalesced along D,
//   32 KB in flight a CTA) before the current tile is accumulated from
//   shared memory, so the loads overlap the accumulation.
// * Offsets into values and out are 64-bit: nb * P * D passes 2^31 at
//   the ogb_products shape (about 1.2e10).

#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 128;         // postings staged a step

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __half* o) {
  *o = __float2half_rn(x);
}

template <typename T, int kD, bool kSplit>
__global__ void __launch_bounds__(kThreads) block_segment_sum_kernel(
    const T* __restrict__ values, const int* __restrict__ ids,
    T* __restrict__ out, int p_len, int d, int s_all, int s_tile,
    int n_dtiles, int n_stiles) {
  constexpr int kGroups = kThreads / kD;
  constexpr int kPer = kChunk * kD / kThreads;  // staged elements a thread
  extern __shared__ float smem[];
  float* acc = smem;                            // [s_tile, kD]
  float* stage = acc + static_cast<size_t>(s_tile) * kD;  // [kChunk, kD]
  int* sid = reinterpret_cast<int*>(stage + kChunk * kD);  // [kChunk]
  int* nonzero = sid + kChunk;                  // [2, kChunk] row flags

  const int tid = threadIdx.x;
  const int col = tid % kD;
  const int grp = tid / kD;
  // the CTAs of one block are adjacent, so its postings stay in L2
  const long long blk = blockIdx.x / (n_dtiles * n_stiles);
  const int d0 = (blockIdx.x / n_stiles % n_dtiles) * kD;
  // without a split (kSplit false) the range is [0, S): the hot loop then
  // compiles as it did before the split existed
  const int s0 = kSplit ? (blockIdx.x % n_stiles) * s_tile : 0;
  const int s_len = kSplit ? min(s_tile, s_all - s0) : s_all;
  const bool live = d0 + col < d;
  const T* vb = values + blk * p_len * static_cast<long long>(d) + d0 + col;
  const int* ib = ids + blk * p_len;

  for (int i = tid; i < s_len * kD; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < 2 * kChunk; i += kThreads) nonzero[i] = 0;

  float reg[kPer];
  int rid = -1;
  auto load = [&](int p0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int p = p0 + grp + j * kGroups;
      reg[j] = (live && p < p_len)
                   ? to_f32(vb[static_cast<long long>(p) * d]) : 0.f;
    }
    // relative to the range, in unsigned arithmetic (no overflow): ids
    // outside [s0, s0 + s_len) land outside [0, s_len) and are dropped
    if (tid < kChunk) {
      rid = p0 + tid < p_len ? ib[p0 + tid] : -1;
      if (kSplit)
        rid = static_cast<int>(static_cast<unsigned>(rid)
                               - static_cast<unsigned>(s0));
    }
  };

  int cur = -1;        // the segment whose running sum `run` holds
  float run = 0.f;
  int buf = 0;
  load(0);
  for (int p0 = 0; p0 < p_len; p0 += kChunk, buf ^= 1) {
    __syncthreads();                  // the last tile is accumulated
    int* nz = nonzero + buf * kChunk;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int r = grp + j * kGroups;
      stage[r * kD + col] = reg[j];
      if (reg[j] != 0.f) nz[r] = 1;   // NaN counts as nonzero
    }
    if (tid < kChunk) sid[tid] = rid;
    __syncthreads();
    // the other flag buffer was last read before this chunk's first
    // barrier, and is next written after the next chunk's
    if (tid < kChunk) nonzero[(buf ^ 1) * kChunk + tid] = 0;
    if (p0 + kChunk < p_len) load(p0 + kChunk);
    // Out-of-range ids (-1, S, another range's) are dropped; ids past P
    // are -1. A row of zeros (the padding) is skipped: adding +-0 leaves
    // a sum as it is (a sum never becomes -0: it starts at +0 and rounds
    // to nearest).
    if constexpr (kD >= 32) {
      const int lane = tid & 31;
#pragma unroll
      for (int q0 = 0; q0 < kChunk; q0 += 32) {
        const int s_l = sid[q0 + lane];
        unsigned m = __ballot_sync(
            0xffffffffu,
            static_cast<unsigned>(s_l) < static_cast<unsigned>(s_len)
                && s_l % kGroups == grp && nz[q0 + lane]);
        while (m) {
          const int q = __ffs(m) - 1;
          m &= m - 1;
          // a segment's postings often come in a run (sorted layouts): its
          // sum stays in a register until another segment comes
          const int s = __shfl_sync(0xffffffffu, s_l, q);
          if (s != cur) {
            if (cur >= 0) acc[cur * kD + col] = run;
            cur = s;
            run = acc[s * kD + col];
          }
          run = __fadd_rn(run, stage[(q0 + q) * kD + col]);
        }
      }
    } else {
      const int n = min(kChunk, p_len - p0);
#pragma unroll 4
      for (int q = 0; q < n; ++q) {
        const int s = sid[q];
        if (static_cast<unsigned>(s) < static_cast<unsigned>(s_len)
            && s % kGroups == grp && nz[q]) {
          float* a = acc + s * kD + col;
          *a = __fadd_rn(*a, stage[q * kD + col]);
        }
      }
    }
  }
  if (cur >= 0) acc[cur * kD + col] = run;
  __syncthreads();
  if (!live) return;
  T* ob = out + (blk * s_all + s0) * static_cast<long long>(d) + d0 + col;
  for (int s = grp; s < s_len; s += kGroups)
    from_f32(acc[s * kD + col], ob + static_cast<long long>(s) * d);
}

template <typename T, int kD, bool kSplit = false>
int launch_tile(const void* values, const void* ids, void* out, long long nb,
                int p_len, int d, int s_all, int s_tile, size_t smem,
                cudaStream_t stream) {
  auto kern = block_segment_sum_kernel<T, kD, kSplit>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_dtiles = (d + kD - 1) / kD;
  const int n_stiles = (s_all + s_tile - 1) / s_tile;
  kern<<<static_cast<unsigned>(nb * n_dtiles * n_stiles), kThreads, smem,
         stream>>>(
      static_cast<const T*>(values), static_cast<const int*>(ids),
      static_cast<T*>(out), p_len, d, s_all, s_tile, n_dtiles, n_stiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* values, const void* ids, void* out, long long nb,
                 int p_len, int d, int s_all, int s_tile, int d_tile,
                 size_t smem, cudaStream_t stream) {
  switch (d_tile) {
    case 64: return launch_tile<T, 64>(values, ids, out, nb, p_len, d, s_all,
                                       s_tile, smem, stream);
    case 32: return launch_tile<T, 32>(values, ids, out, nb, p_len, d, s_all,
                                       s_tile, smem, stream);
    case 16: return launch_tile<T, 16>(values, ids, out, nb, p_len, d, s_all,
                                       s_tile, smem, stream);
    case 8:  // the plan splits S only at 8 columns
      return s_tile < s_all
                 ? launch_tile<T, 8, true>(values, ids, out, nb, p_len, d,
                                           s_all, s_tile, smem, stream)
                 : launch_tile<T, 8>(values, ids, out, nb, p_len, d, s_all,
                                     s_tile, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dynamic shared memory of one CTA, in bytes: the [s_tile, d_tile] f32
// accumulator, the staged [128, d_tile] tile, its 128 ids and two
// buffers of 128 row flags.
extern "C" long long block_segment_sum_smem(int s_tile, int d_tile) {
  return (static_cast<long long>(s_tile) * d_tile + kChunk * d_tile
          + 3 * kChunk) * 4;
}

// Launch on `stream` (dtype 0 = f32, 1 = f16; d_tile in {8, 16, 32, 64};
// S cut into ranges of s_tile segments); returns the CUDA error code (0 on
// success).
extern "C" int block_segment_sum_launch(const void* values, const void* ids,
                                        void* out, long long nb, int p_len,
                                        int d, int s_all, int d_tile,
                                        int s_tile, int dtype, void* stream) {
  if (s_tile < 1 || s_tile > s_all || (s_tile < s_all && d_tile != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(block_segment_sum_smem(s_tile, d_tile));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dtype<float>(values, ids, out, nb, p_len, d, s_all, s_tile,
                               d_tile, smem, st);
  if (dtype == 1)
    return launch_dtype<__half>(values, ids, out, nb, p_len, d, s_all,
                                s_tile, d_tile, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
