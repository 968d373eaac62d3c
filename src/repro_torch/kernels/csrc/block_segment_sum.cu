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
// Bound on the H100: every value is read once (nb * P * D elements, the
// padding included) and every output written once; one FP32 add an
// element is far under the card's 67 TFLOP/s, so 3.35 TB/s of device
// memory bounds it: 14.635 ms at the ogb_products shape ([4,784, 38,912,
// 64] f32, two postings in three padding).
//
// Design. The TPU forms one_hot(ids)^T @ values on the MXU, accumulating
// over P / tile_p tiles in the output block. Here the scatter is direct:
// a CTA holds an [S_TILE, D_TILE] f32 accumulator of one block in shared
// memory (128 KB at S = 512, D_TILE = 64) and walks the block's postings
// in order, adding only the ids of its own range [s0, s0 + S_TILE). There
// is no one-hot product, and no add races another. Two routes feed it;
// the wrapper (block_segment_sum.py::ring_stages) picks one from the plan
// and the operands' addresses, and the kernel assumes nothing else:
//
// * The ring (block_segment_sum_ring), where one CTA holds all S segments
//   and all D columns of a block (column_tile gives D_TILE >= D and
//   S_TILE = S: the ogb_products shape), the values start 16-byte aligned
//   and P * D * elt is a multiple of 16. Then postings [p0, p0 + n) of a
//   block are one contiguous run of n * D * elt bytes, every run starts
//   16-byte aligned, and TMA's 1-D bulk copy moves it into shared memory
//   with no register carrying the data. The CTAs are persistent (one an
//   SM, blocks b, b + grid, ...), in three roles that meet only at the
//   ring's mbarriers:
//   - one producer warp keeps a ring of stages of 64 postings full (as
//     many as fit beside the accumulator, at most 8: 5 of 16 KB at
//     ogb_products); a stage's `full` barrier counts the values' bytes
//     (the bulk copy's transaction count) and its 64 ids (4-byte cp.async
//     copies, one arrival a producer lane). It runs on into the next
//     block's first stages while the adders write the current block out.
//   - eight flag warps set each staged row's all-zero flag (a warp a row,
//     one vote) and arrive on the stage's `ready` barrier;
//   - sixteen adder warps (the accumulator's owners, below) wait on
//     `full` and `ready`, add, and arrive on `empty`, which frees the
//     stage for the producer once every flag and adder warp has left it.
//   No barrier joins the adders, so a group busy with a long run of one
//   segment lags the others by up to the ring's depth instead of holding
//   them at every stage. (On an H100 at 700 W, a first version in which
//   every warp flagged rows and all met at a barrier before adding took
//   36.7 ms at ogb_products, more than the staged path's 30.9.)
// * The staged path (block_segment_sum_kernel, the first design, kept
//   for every other plan): one CTA per (block, D-tile, S-range) when
//   D > 64 (rows strided: several D-tiles), when S is split into ranges
//   (past 7,056 segments, 8 columns), or when the alignment above fails
//   (a view with an odd storage offset, f16 with P * D odd, any P * D *
//   elt that is not a multiple of 16). All 256 threads load the next
//   [128, D_TILE] tile and its ids into registers while the current one
//   is accumulated from shared memory; a row's flag is set as it is
//   stored. Past 7,056 segments every CTA of a range reads all of the
//   block's postings, one more read of the values a range (2 at S =
//   10,000, 8 at S = 50,000).
//
// Both routes add in the same way (add_chunk). Thread t owns column t % D_TILE
// of the segments s0 + r with r % GROUPS == t / D_TILE (GROUPS = adder threads
// / D_TILE; 256 adders staged, 512 in the ring): one writer an accumulator
// element, adding in posting order with __fadd_rn, so the sum order is fixed
// and equals the twin's serial index_add_ bit for bit. With D_TILE >= 32 a
// warp holds one group: it ballots the staged ids 32 at a time and adds only
// its group's postings, in order, keeping the running sum of the current
// segment in a register while its postings come in a run; it reads eight of
// its postings' values back to back before adding them in order, so a run's
// chain is one add a posting and not a shuffle and a load as well. Narrower
// tiles walk every id. A posting whose staged row is all zeros is skipped:
// adding +-0 never changes a sum that starts at +0 and rounds to nearest, so
// the result is bit for bit the same. Padding is such a row: at the
// ogb_products shape two postings in three are padding, all of segment 0, and
// a first version that added them one after another ran at 6.4x its bound.
// Offsets into values and out are 64-bit: nb * P * D passes 2^31 at the
// ogb_products shape (about 1.2e10).

#include <cuda_fp16.h>
#include <cstdint>

#include "bulk_ring.cuh"

namespace {

constexpr int kThreads = 256;       // staged path
constexpr int kChunk = 128;         // postings staged a step
constexpr int kRingN = 64;          // postings a ring stage holds
constexpr int kRingAdders = 512;    // 16 warps: the owners of acc
constexpr int kRingFlaggers = 256;  // 8 warps: the all-zero row flags
constexpr int kRingThreads = kRingAdders + kRingFlaggers + 32;  // + producer
constexpr int kRingMaxStages = 8;
constexpr int kBatch = 8;           // postings read before they are added

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __half* o) {
  *o = __float2half_rn(x);
}

// Adds the n staged postings (row q at stage[q * stride], its id sid[q]
// relative to the CTA's range, its all-zero flag nz[q] == 0) that belong
// to this thread's group into its column of acc, in posting order.
// `cur`/`run` carry the segment whose sum is held in a register.
template <int kD, int kN, int kThr, typename E>
__device__ __forceinline__ void add_chunk(
    const E* stage, int stride, const int* sid, const int* nz, int n,
    int s_len, int grp, int col, bool live, float* acc, int& cur,
    float& run) {
  constexpr int kGroups = kThr / kD;
  // Out-of-range ids (-1, S, another range's) are dropped; ids past P are
  // past n. A row of zeros (the padding) is skipped: adding +-0 leaves a
  // sum as it is (a sum never becomes -0: it starts at +0 and rounds to
  // nearest).
  if constexpr (kD >= 32) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int q0 = 0; q0 < kN; q0 += 32) {
      const int s_l = sid[q0 + lane];
      unsigned m = __ballot_sync(
          0xffffffffu,
          q0 + lane < n
              && static_cast<unsigned>(s_l) < static_cast<unsigned>(s_len)
              && s_l % kGroups == grp && nz[q0 + lane]);
      while (m) {
        // kBatch postings at a time: ids and values first, then the adds
        int seg[kBatch];
        float v[kBatch];
        bool has[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          has[u] = m != 0;
          const int q = has[u] ? __ffs(m) - 1 : 0;
          m &= m - 1;
          seg[u] = __shfl_sync(0xffffffffu, s_l, q);
          v[u] = live && has[u] ? to_f32(stage[(q0 + q) * stride + col])
                                : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (!has[u]) break;
          // a segment's postings often come in a run (sorted layouts):
          // its sum stays in a register until another segment comes
          if (seg[u] != cur) {
            if (cur >= 0) acc[cur * kD + col] = run;
            cur = seg[u];
            run = acc[cur * kD + col];
          }
          run = __fadd_rn(run, v[u]);
        }
      }
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < n; ++q) {
      const int s = sid[q];
      if (live && static_cast<unsigned>(s) < static_cast<unsigned>(s_len)
          && s % kGroups == grp && nz[q]) {
        float* a = acc + s * kD + col;
        *a = __fadd_rn(*a, to_f32(stage[q * stride + col]));
      }
    }
  }
}

// -- the staged path ------------------------------------------------------

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
    add_chunk<kD, kChunk, kThreads>(stage, kD, sid, nz,
                                    min(kChunk, p_len - p0), s_len, grp,
                                    col, live, acc, cur, run);
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

// -- the ring -------------------------------------------------------------

// Shared memory of the ring, in this order: the [s_all, kD] f32
// accumulator, n_stages stages of [kRingN, d] values, n_stages x kRingN
// ids, n_stages x kRingN row flags, and n_stages each of the full, ready
// and empty mbarriers. Every part starts 16-byte aligned (kD >= 8; a
// stage is kRingN * d * elt bytes, a multiple of 128).
long long ring_smem(int s_all, int d_tile, int d, int elt, int n_stages) {
  return static_cast<long long>(s_all) * d_tile * 4
         + static_cast<long long>(n_stages)
               * (static_cast<long long>(kRingN) * d * elt + 2 * kRingN * 4
                  + 3 * 8);
}

template <typename T, int kD>
__global__ void __launch_bounds__(kRingThreads, 1) block_segment_sum_ring(
    const T* __restrict__ values, const int* __restrict__ ids,
    T* __restrict__ out, long long nb, int p_len, int d, int s_all,
    int n_stages) {
  constexpr int kGroups = kRingAdders / kD;
  constexpr int kAdderWarps = kRingAdders / 32;
  constexpr int kFlagWarps = kRingFlaggers / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);          // [s_all, kD]
  const long long stage_elems = static_cast<long long>(kRingN) * d;
  T* stages = reinterpret_cast<T*>(acc + static_cast<size_t>(s_all) * kD);
  int* sids = reinterpret_cast<int*>(stages + n_stages * stage_elems);
  int* flags = sids + n_stages * kRingN;
  uint64_t* full = reinterpret_cast<uint64_t*>(flags + n_stages * kRingN);
  uint64_t* ready = full + n_stages;
  uint64_t* empty = ready + n_stages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < n_stages; ++i) {
      ring::mbar_init(full + i, 1 + 32);   // expect_tx + 32 cp.async lanes
      ring::mbar_init(ready + i, kFlagWarps);
      ring::mbar_init(empty + i, kAdderWarps + kFlagWarps);
    }
    ring::fence_init();
  }
  const int col = tid % kD;
  const int grp = tid / kD;
  const bool live = col < d;
  if (warp < kAdderWarps)                  // each thread its own elements
    for (int s = grp; s < s_all; s += kGroups) acc[s * kD + col] = 0.f;
  __syncthreads();

  int st = 0;
  uint32_t phase = 0;
  auto advance = [&] {
    if (++st == n_stages) { st = 0; phase ^= 1; }
  };
  if (warp == kAdderWarps + kFlagWarps) {  // the producer warp
    for (long long blk = blockIdx.x; blk < nb; blk += gridDim.x) {
      const T* vb = values + blk * p_len * static_cast<long long>(d);
      const int* ib = ids + blk * p_len;
      for (int p0 = 0; p0 < p_len; p0 += kRingN, advance()) {
        const int n = min(kRingN, p_len - p0);
        ring::mbar_wait(empty + st, phase ^ 1);   // the stage is released
        int* sid = sids + st * kRingN;
        for (int q = lane; q < n; q += 32)
          ring::cp_async4(sid + q, ib + p0 + q);
        ring::cp_async_arrive(full + st);
        if (lane == 0) {
          const uint32_t bytes = static_cast<uint32_t>(n) * d * sizeof(T);
          ring::mbar_arrive_expect_tx(full + st, bytes);
          ring::bulk_g2s(stages + st * stage_elems,
                         vb + static_cast<long long>(p0) * d, bytes,
                         full + st);
        }
      }
    }
    // leave only once every stage is released, so no copy of this warp's
    // is still in flight when it exits
    for (int i = 0; i < n_stages; ++i, advance())
      ring::mbar_wait(empty + st, phase ^ 1);
    return;
  }

  if (warp >= kAdderWarps) {               // the flag warps
    const int fw = warp - kAdderWarps;
    for (long long blk = blockIdx.x; blk < nb; blk += gridDim.x) {
      for (int p0 = 0; p0 < p_len; p0 += kRingN, advance()) {
        const int n = min(kRingN, p_len - p0);
        ring::mbar_wait(full + st, phase);
        const T* stage = stages + st * stage_elems;
        int* nz = flags + st * kRingN;
#pragma unroll
        for (int j = 0; j < kRingN / kFlagWarps; ++j) {   // a row a vote
          const int r = fw + j * kFlagWarps;
          bool any = false;
#pragma unroll
          for (int c0 = 0; c0 < kD; c0 += 32) {
            const int c = c0 + lane;
            if (r < n && c < d)                          // NaN is nonzero
              any |= to_f32(stage[r * d + c]) != 0.f;
          }
          any = __any_sync(0xffffffffu, any);
          if (lane == 0 && r < n) nz[r] = any;
        }
        __syncwarp();
        if (lane == 0) {
          ring::mbar_arrive(ready + st);
          ring::mbar_arrive(empty + st);
        }
      }
    }
    return;
  }

  // the adders: no barrier among them, so a group busy with a long run
  // of one segment lags the others by up to the ring's depth
  for (long long blk = blockIdx.x; blk < nb; blk += gridDim.x) {
    int cur = -1;      // the segment whose running sum `run` holds
    float run = 0.f;
    for (int p0 = 0; p0 < p_len; p0 += kRingN, advance()) {
      const int n = min(kRingN, p_len - p0);
      ring::mbar_wait(full + st, phase);
      ring::mbar_wait(ready + st, phase);
      add_chunk<kD, kRingN, kRingAdders>(stages + st * stage_elems, d,
                                         sids + st * kRingN,
                                         flags + st * kRingN, n, s_all, grp,
                                         col, live, acc, cur, run);
      __syncwarp();
      if (lane == 0) ring::mbar_arrive(empty + st);   // release the stage
    }
    if (cur >= 0) acc[cur * kD + col] = run;
    // write the block out and zero the accumulator: each thread its own
    // elements, so no barrier; the producer is already filling the ring
    T* ob = out + blk * s_all * static_cast<long long>(d) + col;
    for (int s = grp; s < s_all; s += kGroups) {
      if (live)
        from_f32(acc[s * kD + col], ob + static_cast<long long>(s) * d);
      acc[s * kD + col] = 0.f;
    }
  }
}

template <typename T, int kD>
int launch_ring_tile(const void* values, const void* ids, void* out,
                     long long nb, int p_len, int d, int s_all, int n_stages,
                     size_t smem, cudaStream_t stream) {
  auto kern = block_segment_sum_ring<T, kD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, n_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = nb < n_sm ? nb : n_sm;
  kern<<<static_cast<unsigned>(grid), kRingThreads, smem, stream>>>(
      static_cast<const T*>(values), static_cast<const int*>(ids),
      static_cast<T*>(out), nb, p_len, d, s_all, n_stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ring(const void* values, const void* ids, void* out, long long nb,
                int p_len, int d, int s_all, int d_tile, int n_stages,
                size_t smem, cudaStream_t stream) {
  switch (d_tile) {
    case 64: return launch_ring_tile<T, 64>(values, ids, out, nb, p_len, d,
                                            s_all, n_stages, smem, stream);
    case 32: return launch_ring_tile<T, 32>(values, ids, out, nb, p_len, d,
                                            s_all, n_stages, smem, stream);
    case 16: return launch_ring_tile<T, 16>(values, ids, out, nb, p_len, d,
                                            s_all, n_stages, smem, stream);
    case 8: return launch_ring_tile<T, 8>(values, ids, out, nb, p_len, d,
                                          s_all, n_stages, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Dynamic shared memory of one staged-path CTA, in bytes: the [s_tile,
// d_tile] f32 accumulator, the staged [128, d_tile] tile, its 128 ids and
// two buffers of 128 row flags.
extern "C" long long block_segment_sum_smem(int s_tile, int d_tile) {
  return (static_cast<long long>(s_tile) * d_tile + kChunk * d_tile
          + 3 * kChunk) * 4;
}

// Dynamic shared memory of one ring CTA, in bytes (see ring_smem).
extern "C" long long block_segment_sum_ring_smem(int s_all, int d_tile,
                                                 int d, int elt,
                                                 int n_stages) {
  return ring_smem(s_all, d_tile, d, elt, n_stages);
}

// Launch the staged path on `stream` (dtype 0 = f32, 1 = f16; d_tile in
// {8, 16, 32, 64}; S cut into ranges of s_tile segments); returns the
// CUDA error code (0 on success).
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

// Launch the ring on `stream` (one CTA a block's S segments and D <=
// d_tile columns; n_stages in [2, 8]); refuses values that are not
// 16-byte aligned or a P * D * elt that is not a multiple of 16, which
// the bulk copy needs. Returns the CUDA error code (0 on success).
extern "C" int block_segment_sum_ring_launch(const void* values,
                                             const void* ids, void* out,
                                             long long nb, int p_len, int d,
                                             int s_all, int d_tile,
                                             int n_stages, int dtype,
                                             void* stream) {
  const int elt = dtype == 0 ? 4 : 2;
  if (d > d_tile || n_stages < 2 || n_stages > kRingMaxStages
      || reinterpret_cast<uintptr_t>(values) % 16 != 0
      || static_cast<long long>(p_len) * d * elt % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(ring_smem(s_all, d_tile, d, elt, n_stages));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_ring<float>(values, ids, out, nb, p_len, d, s_all, d_tile,
                              n_stages, smem, st);
  if (dtype == 1)
    return launch_ring<__half>(values, ids, out, nb, p_len, d, s_all,
                               d_tile, n_stages, smem, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
