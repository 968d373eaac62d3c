// K5: per-segment top-k of the rows of a dense [R, n] score matrix.
//
// Replaces: src/repro/kernels/blockwise_topk.py::blockwise_topk_kernel
// (_kernel, select_topk; pallas_call at blockwise_topk.py:70).
//
// What it computes: row r of x ([R, n] f32, rows n apart) is cut into
// nb = ceil(n / block) segments of `block` entries, the last one holding
// only the n - (nb - 1) * block that exist (positions past it are absent,
// never selected). For segment (r, j), output row r * nb + j lists its
// best k entries in (value desc, position asc) order: values [., k] f32
// and segment-local positions [., k] i32. Slots past the segment's length
// hold (-INF, -1). With n == block this is the reference's [nb, block] ->
// [nb, k] contract. NaN input is out of contract: the BM25 paths never
// produce it and the serving ladder's finite check covers boards.
//
// Bound on the H100: every input float is read once (4 bytes against
// 3.35 TB/s) and k (value, position) pairs a segment are written: 0.672
// ms at ops.topk's full-width shape ([256, 2,097,152], block 4096, k 100:
// 2.15 GB read, 131,072 x 100 pairs written). The compares are a few per
// entry, far under the card's rates.
//
// What the first version lost: k rounds of a CTA-wide best, each
// a warp butterfly, a barrier, a read of 8 warp winners and a serial
// rescan of the winner's 16 entries by one thread: O(k * block / 256)
// steps deep a segment, 25.8 ms at that shape (38x its bound, 4.1x
// torch.topk). This version selects in O(block / 256) steps plus a
// ranking of the few candidates.
//
// Design, one CTA of 256 threads a segment:
// * Order key. Each value becomes a u32 whose unsigned order is the
//   values' order, after -0.0 is folded onto +0.0 (x + 0.0f, as
//   core/retrieval.py::rank_order does): the twin ranks +0.0 and -0.0 as
//   equal, and the raw bits would not. Every real key is >= 0x007FFFFF
//   (-inf), so 0 stands below all of them. The output values are read
//   back from x at the winning positions, so they keep their own bits.
// * Load once. Warp w owns the positions [w * 32 * per, (w + 1) * 32 *
//   per) (per = ceil(block / 256)), lane l the ones l, l + 32, ... of
//   them: each load is 128 coalesced bytes a warp, and a warp's ballots
//   walk its positions in order. The keys stay in shared memory.
// * A threshold without atomics (k <= 256). Each warp sorts its 32 lane
//   maxima with a shuffle bitonic sort and takes the q-th largest, q =
//   ceil(k / 8); tau = the least of the 8. Each warp holds q entries >=
//   tau, so at least k entries are: the k-th largest key is >= tau. If
//   fewer than k keys exceed tau, tau is the k-th key itself and nothing
//   else is searched.
// * Otherwise the k-th key exceeds tau. Few keys do (for BM25 rows a few
//   hundred of the segment's 4096): up to 512 of them are all kept and
//   ranked below. More than that go through a radix select for the k-th
//   key: 8-bit digits from the top, shared integer histograms (integer
//   atomics count exactly in any order; no float is ever added), a
//   CTA-wide suffix scan to find the digit, and a stop as soon as the
//   entries above a bin plus the bin itself make exactly k.
// * Compaction in position order. Every key above the threshold is taken,
//   and of the keys equal to it the lowest-positioned k - c: each warp
//   counts with ballots in position order, one exclusive scan over the 8
//   warps gives the bases. No atomics pick among tied positions.
// * The candidates, as (key << 32 | ~position), are distinct, so their
//   order (key desc, position asc) is total: they are ranked by count (a
//   candidate's rank is the number ahead of it, one broadcast read a
//   compare, no barrier; O(c^2 / 256) steps, a few hundred at k = 100)
//   and the k best written at their ranks. Positions are distinct by
//   construction, also in rows of -inf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;                       // 8-bit digits
constexpr int kRankMax = 2 * kThreads;   // keys above tau ranked directly
constexpr unsigned kFull = 0xffffffffu;

// Ascending keys for ascending values, -0.0 folded onto +0.0.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.0f));
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// CTA-wide sum of one value a thread (every thread gets it); s_tmp
// ([kWarps]) may be written again only after the next barrier.
__device__ __forceinline__ unsigned cta_sum(unsigned v, unsigned* s_tmp) {
  v = __reduce_add_sync(kFull, v);
  __syncthreads();                               // s_tmp is free
  if ((threadIdx.x & 31) == 0) s_tmp[threadIdx.x >> 5] = v;
  __syncthreads();
  unsigned t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s_tmp[w];
  return t;
}

// An input element widened exactly to f32 (order kept), and -inf as T.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T neg_inf();
template <> __device__ __forceinline__ float neg_inf<float>() {
  return -INFINITY;
}
template <> __device__ __forceinline__ __nv_bfloat16 neg_inf<__nv_bfloat16>() {
  return __float2bfloat16_rn(-INFINITY);
}

// T: x's and the values' element, float or bf16. The bf16 instantiation
// compares the exact f32 widening of each entry (the f32 kernel's keys)
// and writes back the entries themselves: its values are the f32
// kernel's on the widened row, narrowed back, and its positions the same.
template <typename T>
__global__ void __launch_bounds__(kThreads) blockwise_topk_kernel(
    const T* __restrict__ x, int n, int block, int nb, int k, int per,
    int cap, T* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* cand = smem_u64;           // [cap] candidates
  unsigned* keys = reinterpret_cast<unsigned*>(cand + cap);  // [256*per]
  __shared__ unsigned hist[kBins];
  __shared__ unsigned s_a[kWarps], s_e[kWarps];
  __shared__ unsigned s_pick[3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long seg = blockIdx.x;
  const long long row = seg / nb;
  const int j = static_cast<int>(seg % nb);
  const int len = min(block, n - j * block);
  const T* src = x + row * n + static_cast<long long>(j) * block;
  const int base = warp * 32 * per + lane;       // my first position
  const unsigned lt = (1u << lane) - 1u;         // lanes before mine

  // -- load: keys in position order, each lane's maximum ---------------
  unsigned tmax = 0;
#pragma unroll 4
  for (int i = 0; i < per; ++i) {
    const int p = base + i * 32;
    const unsigned key = p < len ? order_key(widen(src[p])) : 0u;
    keys[p] = key;
    tmax = max(tmax, key);
  }

  // -- the threshold: entries above `floor_`, masked keys vs `prefix` ----
  // selected = key > floor_ && ((key & mask) > prefix
  //                            || ((key & mask) == prefix && eq rank < rem))
  unsigned floor_ = 0, mask = 0, prefix = 0;
  unsigned rem = static_cast<unsigned>(len);     // len <= k: take all
  int n_cand = len;                              // candidates compacted
  if (len > k) {
    n_cand = k;
    unsigned tau = 0;
    if (k <= kThreads) {
      unsigned v = tmax;                         // sort the lane maxima
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const unsigned o = __shfl_xor_sync(kFull, v, stride);
          const bool keep_max =
              ((lane & stride) == 0) == ((lane & size) == 0);
          v = keep_max ? max(v, o) : min(v, o);
        }
      }
      v = __shfl_sync(kFull, v, (k + kWarps - 1) / kWarps - 1);
      if (lane == 0) s_a[warp] = v;
      __syncthreads();
      tau = s_a[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) tau = min(tau, s_a[w]);
    }
    unsigned c = 0;                              // keys above tau
    for (int i = 0; i < per; ++i) {
      const int p = base + i * 32;
      c += (p < len && keys[p] > tau) ? 1u : 0u;
    }
    const unsigned c_gt = cta_sum(c, s_a);
    if (c_gt < static_cast<unsigned>(k)) {       // tau is the k-th key
      mask = kFull;
      prefix = tau;
      rem = static_cast<unsigned>(k) - c_gt;
    } else if (c_gt <= static_cast<unsigned>(kRankMax)) {
      floor_ = tau;                              // few keys above tau: all
      rem = c_gt;                                // of them are ranked below
      n_cand = static_cast<int>(c_gt);
    } else {                                     // the k-th key is above
      floor_ = tau;
      rem = static_cast<unsigned>(k);
      for (int shift = 24; shift >= 0; shift -= 8) {
        hist[tid] = 0;
        __syncthreads();
        for (int i = 0; i < per; ++i) {
          const int p = base + i * 32;
          if (p >= len) break;
          const unsigned key = keys[p];
          if (key > floor_ && (key & mask) == prefix)
            atomicAdd(&hist[(key >> shift) & (kBins - 1)], 1u);
        }
        __syncthreads();
        // inclusive scan of the bins from the top: thread t holds bin
        // 255 - t, so `incl` counts the bins >= it and `above` those > it
        const unsigned h = hist[kBins - 1 - tid];
        unsigned incl = h;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        if (lane == 31) s_e[warp] = incl;
        __syncthreads();
        for (int w = 0; w < warp; ++w) incl += s_e[w];
        const unsigned above = incl - h;
        if (above < rem && incl >= rem) {        // one bin holds the k-th
          s_pick[0] = kBins - 1 - tid;
          s_pick[1] = above;
          s_pick[2] = h;
        }
        __syncthreads();
        rem -= s_pick[1];
        prefix |= s_pick[0] << shift;
        mask |= static_cast<unsigned>(kBins - 1) << shift;
        const bool exact = s_pick[2] == rem;     // the whole bin is taken
        __syncthreads();                         // s_pick, s_e are read
        if (exact) break;
      }
    }
  }

  // -- compaction in position order: above first, then the tied ones -----
  __syncthreads();                               // s_a, s_e are free
  unsigned na = 0, ne = 0;
  for (int i = 0; i < per; ++i) {
    const int p = base + i * 32;
    const unsigned key = p < len ? keys[p] : 0u;
    const bool live = p < len && key > floor_;
    na += __popc(__ballot_sync(kFull, live && (key & mask) > prefix));
    ne += __popc(__ballot_sync(kFull, live && (key & mask) == prefix));
  }
  if (lane == 0) {
    s_a[warp] = na;
    s_e[warp] = ne;
  }
  __syncthreads();
  unsigned a_at = 0, e_at = 0, n_above = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      a_at += s_a[w];
      e_at += s_e[w];
    }
    n_above += s_a[w];
  }
  for (int i = 0; i < per; ++i) {
    const int p = base + i * 32;
    const unsigned key = p < len ? keys[p] : 0u;
    const bool live = p < len && key > floor_;
    const bool is_a = live && (key & mask) > prefix;
    const bool is_e = live && (key & mask) == prefix;
    const unsigned ma = __ballot_sync(kFull, is_a);
    const unsigned me = __ballot_sync(kFull, is_e);
    const unsigned long long packed =
        (static_cast<unsigned long long>(key) << 32)
        | ~static_cast<unsigned>(p);
    if (is_a) cand[a_at + __popc(ma & lt)] = packed;
    if (is_e) {
      const unsigned r = e_at + __popc(me & lt);
      if (r < rem) cand[n_above + r] = packed;
    }
    a_at += __popc(ma);
    e_at += __popc(me);
  }
  __syncthreads();

  // -- the k best candidates by rank: a candidate's rank is the number of
  // candidates ahead of it in (key desc, position asc) order; the keys
  // (key << 32 | ~position) are distinct, so the ranks are too ------------
  for (int i0 = 0; i0 < n_cand; i0 += 2 * kThreads) {
    const int i[2] = {i0 + tid, i0 + kThreads + tid};
    const unsigned long long mine[2] = {
        i[0] < n_cand ? cand[i[0]] : ~0ull,
        i[1] < n_cand ? cand[i[1]] : ~0ull};
    int rank[2] = {0, 0};
    if (i0 + warp * 32 < n_cand) {               // warp-uniform
#pragma unroll 8
      for (int j = 0; j < n_cand; ++j) {
        const unsigned long long c = cand[j];    // one address: broadcast
        rank[0] += c > mine[0];
        rank[1] += c > mine[1];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (i[h] < n_cand && rank[h] < k) {
        const size_t o = static_cast<size_t>(seg) * k + rank[h];
        const int p = static_cast<int>(~static_cast<unsigned>(mine[h]));
        out_v[o] = src[p];
        out_i[o] = p;
      }
    }
  }
  for (int i = n_cand + tid; i < k; i += kThreads) {
    const size_t o = static_cast<size_t>(seg) * k + i;
    out_v[o] = neg_inf<T>();
    out_i[o] = -1;
  }
}

}  // namespace

// Candidate slots a CTA keeps: k, and at least kRankMax (the keys above
// the threshold, when they are few, are all ranked).
extern "C" int blockwise_topk_cap(int k) { return max(k, kRankMax); }

// Dynamic shared memory the kernel needs, in bytes: the sort keys and
// the segment's order keys (256 * ceil(block / 256) slots).
extern "C" long long blockwise_topk_smem(int block, int k) {
  const long long per = (block + kThreads - 1) / kThreads;
  return static_cast<long long>(blockwise_topk_cap(k)) * 8
         + per * kThreads * 4;
}

namespace {

template <typename T>
int topk_launch(const void* x, long long n_rows, int n, int block, int k,
                void* out_v, void* out_i, void* stream) {
  const long long smem = blockwise_topk_smem(block, k);
  cudaError_t err = cudaFuncSetAttribute(
      blockwise_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + block - 1) / block;
  const long long grid = n_rows * nb;
  const int per = (block + kThreads - 1) / kThreads;
  blockwise_topk_kernel<T><<<static_cast<unsigned>(grid), kThreads,
                             static_cast<size_t>(smem),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), n, block, nb, k, per, blockwise_topk_cap(k),
      static_cast<T*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the CUDA error code (0 on success).
extern "C" int blockwise_topk_launch(const void* x, long long n_rows, int n,
                                     int block, int k, void* out_v,
                                     void* out_i, void* stream) {
  return topk_launch<float>(x, n_rows, n, block, k, out_v, out_i, stream);
}

// The bf16 instantiation: bf16 x and values, i32 positions.
extern "C" int blockwise_topk_bf16_launch(const void* x, long long n_rows,
                                          int n, int block, int k,
                                          void* out_v, void* out_i,
                                          void* stream) {
  return topk_launch<__nv_bfloat16>(x, n_rows, n, block, k, out_v, out_i,
                                    stream);
}
