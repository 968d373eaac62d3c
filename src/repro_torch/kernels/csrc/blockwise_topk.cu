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
// 3.35 TB/s) and k (value, position) pairs a segment are written; the
// compares are a few per entry, far under the card's rates.
//
// Design:
// * One CTA of 256 threads per segment. The segment is copied once into
//   shared memory (16 KB at block 4096), coalesced; thread t owns the
//   positions p with p % 256 == t.
// * k rounds of a CTA-wide best under one total order, value descending
//   then position ascending (select_topk.cuh::rank_before): each thread
//   offers its own best, a warp butterfly (warp_best) and a read of the 8
//   warp winners pick the CTA's, double-buffered so a round costs one
//   barrier.
// * Taken entries are never written over. The reference masks a taken
//   entry with the float minimum, so once a row's larger entries run out
//   argmax can return a taken position again (rows of -inf or -FLT_MAX).
//   Here the winner's owner remembers what it gave up and its next offer
//   is the best of its entries ranking strictly after that one: under a
//   total order every position is offered at most once, so the k
//   positions are distinct whatever the values.
// * Only the thread whose entry won rescans its block / 256 entries; the
//   other threads keep their offer. The TPU's k full passes over the row
//   become k CTA reductions plus one short rescan each.

#include "select_topk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Best entry of thread `tid`'s positions tid, tid + kThreads, ... < len
// that ranks strictly after (lv, lp) (every entry when lp < 0).
__device__ __forceinline__ void next_offer(const float* seg, int len,
                                           int tid, float lv, int lp,
                                           float& v, int& p) {
  v = -INFINITY;
  p = INT_MAX;
  for (int q = tid; q < len; q += kThreads) {
    const float x = seg[q];
    if (lp >= 0 && !bm25::rank_before(lv, lp, x, q)) continue;
    if (bm25::rank_before(x, q, v, p)) {
      v = x;
      p = q;
    }
  }
}

__global__ void __launch_bounds__(kThreads) blockwise_topk_kernel(
    const float* __restrict__ x, int n, int block, int nb, int k,
    float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float seg[];                 // [block]
  __shared__ float s_v[2][kWarps];
  __shared__ int s_p[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long r = blockIdx.x;
  const long long row = r / nb;
  const int j = static_cast<int>(r % nb);
  const int len = min(block, n - j * block);
  const float* src = x + row * n + static_cast<long long>(j) * block;

  for (int q = tid; q < len; q += kThreads) seg[q] = src[q];
  __syncthreads();

  float v;
  int p;
  next_offer(seg, len, tid, 0.f, -1, v, p);
  for (int i = 0; i < k; ++i) {
    float bv = v;
    int bp = p, dummy = p;
    bm25::warp_best(bv, bp, dummy);
    const int buf = i & 1;
    if (lane == 0) {
      s_v[buf][warp] = bv;
      s_p[buf][warp] = bp;
    }
    __syncthreads();
    bv = s_v[buf][0];
    bp = s_p[buf][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float ov = s_v[buf][w];
      const int op = s_p[buf][w];
      if (bm25::rank_before(ov, op, bv, bp)) {
        bv = ov;
        bp = op;
      }
    }
    // no entry left: the segment is shorter than k
    if (tid == 0) {
      const size_t o = static_cast<size_t>(r) * k + i;
      out_v[o] = bp == INT_MAX ? -INFINITY : bv;
      out_i[o] = bp == INT_MAX ? -1 : bp;
    }
    if (bp != INT_MAX && p == bp) next_offer(seg, len, tid, v, p, v, p);
  }
}

}  // namespace

// Dynamic shared memory the kernel needs, in bytes.
extern "C" long long blockwise_topk_smem(int block) {
  return static_cast<long long>(block) * 4;
}

// Launch on `stream`; returns the CUDA error code (0 on success).
extern "C" int blockwise_topk_launch(const void* x, long long n_rows, int n,
                                     int block, int k, void* out_v,
                                     void* out_i, void* stream) {
  const long long smem = blockwise_topk_smem(block);
  cudaError_t err = cudaFuncSetAttribute(
      blockwise_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nb = (n + block - 1) / block;
  const long long grid = n_rows * nb;
  blockwise_topk_kernel<<<static_cast<unsigned>(grid), kThreads,
                          static_cast<size_t>(smem),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, block, nb, k,
      static_cast<float*>(out_v), static_cast<int*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
