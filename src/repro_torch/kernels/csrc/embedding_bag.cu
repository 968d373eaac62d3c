// K8: EmbeddingBag, the weighted row gather-and-sum of the sparse
// substrate (recsys multi-hot fields, sampled GNN neighbourhoods).
//
// Replaces: src/repro/kernels/embedding_bag.py::embedding_bag_kernel
// (_kernel; pallas_call at embedding_bag.py:112).
//
// What it computes: with a [V, D] f32 table, [B, F] i32 indices (-1 =
// pad) and [B, F] f32 weights,
//   out[b, :] = sum over f in fanout order, skipping pads, of
//               fl(weights[b, f] * table[indices[b, f], :]),
// each product and each sum rounded separately (__fmul_rn, __fadd_rn), so
// the result equals the twin's bit for bit. The reference fetches row 0
// for a pad and multiplies it by 0; skipping it gives the same sums for
// a finite table (a row 0 holding inf or NaN is out of contract). Indices
// must lie in [-1, V): the kernel does not check (a check would cost a
// synchronisation); the twin raises outside that range.
//
// Bound on the H100: each distinct row that a valid slot names is read
// once (D * 4 bytes; a row named by several slots need not be read
// again), and every valid slot costs D multiplies and D adds; the
// indices, weights and the output are read or written once. At two FP32
// operations a 4-byte element the card's 3.35 TB/s, not its 67 TFLOP/s,
// bounds it. At Reddit's hop-1 call ([1,024, 15] bags, D = 602) that is
// 0.0108 ms, and the rows (36 MB) fit in the 50 MB L2: the call is short
// enough that latency, not bytes, decides its time.
//
// Design:
// * The TPU scalar-prefetches the indices into SMEM to drive row DMAs,
//   double-buffered so one row's copy overlaps the previous row's
//   accumulate. Here a warp owns one (bag, slice of 32 * W columns): lane
//   l holds columns c0 + l*W .. c0 + l*W + W - 1 of the sum in registers.
//   A bag's slices go to adjacent warps, so at hop-1 (D = 602, W = 2:
//   ten slices) 1,024 bags keep 10,240 warps in flight where a warp a bag
//   kept 1,024.
// * A bag's slots are loaded once, 32 at a time: lane f loads index f
//   and weight f, the valid slots are found by one __ballot_sync, and
//   each valid slot's index and weight reach every lane by __shfl_sync,
//   in fanout order. Eight row loads go out back to back before the
//   first of them is added, so no load waits on an index load or on
//   another row; the adds then run in fanout order, so each output
//   element is still summed by one thread, its only writer, in the twin's
//   order; no sum is split across threads.
// * W is the load width in floats, chosen by the wrapper
//   (embedding_bag.py::load_width) from the table's and the output's
//   addresses and D: 4 (16-byte loads) where both are 16-byte aligned and
//   D % 4 == 0, 2 where both are 8-byte aligned and D is even (Reddit's
//   602: every row 8-byte aligned), 1 otherwise. The kernel assumes no
//   alignment the wrapper did not check.
// * The row offset index * D is 64-bit: a table of more than 2^31
//   elements (e.g. a 39,979,771 x 128 field) must work.

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;           // row loads sent before the adds

template <int W> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&v)[W]) {
  const auto x = __ldg(reinterpret_cast<const typename Vec<W>::T*>(p));
  if constexpr (W == 1) {
    v[0] = x;
  } else if constexpr (W == 2) {
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
}

template <int W>
__device__ __forceinline__ void store_row(float* p, const float (&v)[W]) {
  if constexpr (W == 1) {
    *p = v[0];
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const float* __restrict__ table, const int* __restrict__ indices,
    const float* __restrict__ weights, float* __restrict__ out, long long b,
    int f_len, int d, int n_slices) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (warp >= b * n_slices) return;            // the whole warp leaves
  const long long bag = warp / n_slices;
  const int c = static_cast<int>(warp % n_slices) * (32 * W) + lane * W;
  const bool live = c < d;                     // W divides d
  const int* bi = indices + bag * f_len;
  const float* bw = weights + bag * f_len;
  float acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.f;
  for (int f0 = 0; f0 < f_len; f0 += 32) {
    const int f = f0 + lane;
    const int my_i = f < f_len ? __ldg(bi + f) : -1;
    const float my_w = f < f_len ? __ldg(bw + f) : 0.f;
    unsigned m = __ballot_sync(0xffffffffu, my_i >= 0);   // a pad adds
    while (m) {                                             // nothing
      float w[kBatch], v[kBatch][W];
      bool has[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {       // the loads, back to back
        has[u] = m != 0;
        const int q = has[u] ? __ffs(m) - 1 : 0;
        m &= m - 1;
        const int i = __shfl_sync(0xffffffffu, my_i, q);
        w[u] = __shfl_sync(0xffffffffu, my_w, q);
#pragma unroll
        for (int k = 0; k < W; ++k) v[u][k] = 0.f;
        if (has[u] && live)
          load_row<W>(table + static_cast<long long>(i) * d + c, v[u]);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {       // the adds, in fanout order
        if (!has[u]) break;
#pragma unroll
        for (int k = 0; k < W; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(w[u], v[u][k]));
      }
    }
  }
  if (live) store_row<W>(out + bag * d + c, acc);
}

template <int W>
int launch(const void* table, const void* indices, const void* weights,
           void* out, long long b, int f_len, int d, cudaStream_t stream) {
  const int n_slices = (d + 32 * W - 1) / (32 * W);
  const long long grid = (b * n_slices + kWarps - 1) / kWarps;
  embedding_bag_kernel<W><<<static_cast<unsigned>(grid), kThreads, 0,
                            stream>>>(
      static_cast<const float*>(table), static_cast<const int*>(indices),
      static_cast<const float*>(weights), static_cast<float*>(out), b, f_len,
      d, n_slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` (b >= 1; width = floats a lane loads at once, 1, 2
// or 4, with the table and out aligned to it and d a multiple of it, as
// the wrapper checks); returns the CUDA error code (0 on success).
extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    const void* weights, void* out,
                                    long long b, int f_len, int d, int width,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1: return launch<1>(table, indices, weights, out, b, f_len, d, st);
    case 2: return launch<2>(table, indices, weights, out, b, f_len, d, st);
    case 4: return launch<4>(table, indices, weights, out, b, f_len, d, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
