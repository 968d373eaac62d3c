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
// bounds it.
//
// Design:
// * The TPU scalar-prefetches the indices into SMEM to drive row DMAs,
//   double-buffered so one row's copy overlaps the previous row's
//   accumulate. Here a warp owns a bag: its lanes read each row's
//   columns lane, lane + 32, ... (128 contiguous bytes a warp load) and
//   keep 4 columns a lane in registers per pass over the fanout, so a
//   slot issues 4 independent row loads and the unrolled fanout loop
//   keeps several slots' loads in flight. The bag's indices and weights
//   are warp-uniform loads from L1.
// * Loads are 4-byte: a row of D = 602 (Reddit's features) starts only
//   8-byte aligned, so 16-byte vector loads of odd rows would fault.
// * The row offset index * D is 64-bit: a table of more than 2^31
//   elements (e.g. a 39,979,771 x 128 field) must work.

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;            // columns a lane holds per pass

__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const float* __restrict__ table, const int* __restrict__ indices,
    const float* __restrict__ weights, float* __restrict__ out, long long b,
    int f_len, int d) {
  const int lane = threadIdx.x & 31;
  const long long bag =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (bag >= b) return;
  const int* bi = indices + bag * f_len;
  const float* bw = weights + bag * f_len;
  float* ob = out + bag * d;
  for (int c0 = 0; c0 < d; c0 += 32 * kCols) {
    float acc[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) acc[u] = 0.f;
#pragma unroll 4
    for (int f = 0; f < f_len; ++f) {
      const int i = __ldg(bi + f);
      if (i < 0) continue;                     // a pad adds nothing
      const float w = __ldg(bw + f);
      const float* row = table + static_cast<long long>(i) * d;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int c = c0 + lane + 32 * u;
        if (c < d) acc[u] = __fadd_rn(acc[u], __fmul_rn(w, __ldg(row + c)));
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int c = c0 + lane + 32 * u;
      if (c < d) ob[c] = acc[u];
    }
  }
}

}  // namespace

// Launch on `stream` (b >= 1); returns the CUDA error code (0 on success).
extern "C" int embedding_bag_launch(const void* table, const void* indices,
                                    const void* weights, void* out,
                                    long long b, int f_len, int d,
                                    void* stream) {
  const long long grid = (b + kWarps - 1) / kWarps;
  embedding_bag_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(indices),
      static_cast<const float*>(weights), static_cast<float*>(out), b, f_len,
      d);
  return static_cast<int>(cudaGetLastError());
}
