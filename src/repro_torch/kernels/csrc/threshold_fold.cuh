// The threshold fold of a [rows, 64] shared accumulator into sorted
// per-column boards, shared by K1/K3 (bm25_resident.cu: a span into the
// CTA's running board) and K2/K4 (block_topk.cuh: a window of a block's
// rows into the block's board, empty before its first window).
//
// Replaces the TPU kernels' k rounds of max / argmax / mask a column
// (src/repro/kernels/blockwise_topk.py::select_topk, and the winner fold
// of src/repro/kernels/bm25_gather_score.py::_fold_winners).
//
// A board column holds k (value, id) entries sorted by (score desc, id
// asc) (select_topk.cuh's rank_before), contiguous, and the column's row
// k - 1 is also kept as its threshold (thr_v, thr_g). The fold has two
// passes over the accumulator (16 warps, two query columns a lane, row r
// belonging to warp r % 16, at most kFoldRows rows):
// 1. fold_mark: each warp marks, for its lane's two columns, which of its
//    32 rows rank before the column's threshold: one conflict-free pass,
//    one 32-bit mask a (warp, column).
// 2. fold_merge: each warp takes kFoldWarpCols columns and merges only
//    the marked rows, 32 at a time, into the sorted column by rank
//    (merge_column): a board entry moves down by the candidates ahead of
//    it, a candidate lands at the count of the entries and candidates
//    ahead of it (ballots, no sort), the column rewritten in place from
//    its last rows up. A candidate that an earlier merge's raised
//    threshold has overtaken is dropped before it is merged, and merging
//    against a stale threshold is still exact (a stale candidate ranks at
//    or past k and is not written).
// An empty board is k entries that rank below every real one: (-INF,
// INT_MAX), with the same threshold; then every real row (a padding row at
// -FLT_MAX too) is a candidate and the board ends holding the column's
// first k rows in the port's order.
//
// fold_select is the fold of a block's only window into its empty board
// (K2 and K4 with at most 512 rows), where every row is a candidate and
// merging them 32 at a time is a long chain of dependent shuffles (60.7
// of K2's 93.2 ms at phase 5's shapes): it takes the board kSelectK rows
// a pass. A pass computes each column's kp-th key exactly, by a bitwise
// search of counts (32 rounds, each one count a (warp, column) and a
// barrier pair); lists the rows above it, fewer than kp, and ranks each by
// the count of list entries above it (8 threads a column); and appends the
// rows at the kp-th key in row order after them, as many as kp needs. The
// pass's rows go to a [kp, 64] staged board and leave the keys, so the
// next pass takes the board's next rows. The result is the merge's.
// The fold only compares and moves entries: it adds nothing and uses no
// atomics, so a board holds the sums the walk made (__fmul_rn then
// __fadd_rn, in posting order) bit for bit.
//
// Bound: one read of the accumulator a fold, and for each merged
// candidate one pass over the column's k entries (k / 32 shuffles).
#pragma once

#include <cfloat>
#include <climits>

#include "owner_round.cuh"
#include "select_topk.cuh"

namespace bm25 {

constexpr int kFoldRows = 32 * kRoundWarps;   // a warp's rows in one mask
constexpr int kFoldWarpCols = kRoundCols / kRoundWarps;  // a warp merges
constexpr int kFoldMaskBytes = kRoundWarps * kRoundCols * 4;
constexpr int kSelectK = 128;            // fold_select takes k <= 128
constexpr int kSelectLd = kSelectK + 1;  // a column's list stride (odd:
                                         // a warp's 4 columns, 4 banks)
// fold_select's shared scratch: per (warp, column) counts and tie masks,
// the columns' k-th keys and list lengths, and the lists.
constexpr int kSelectScratchBytes =
    2 * kFoldMaskBytes + 2 * kRoundCols * 4 + kRoundCols * kSelectLd * 8;

// An unsigned key in the order of the float, -0.0 folded onto +0.0 as
// rank_before compares them; key_value inverts it (to +0.0 for -0.0).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Position of the n-th (from 0) set bit of m; n < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const int lo = __popc(m & ((1u << s) - 1u));
    if (n >= lo) {
      n -= lo;
      m >>= s;
      pos += s;
    }
  }
  return pos;
}

// Merge the lanes' candidates (v, g), where `valid`, into the sorted
// column (col_v, col_g)[0, k) of a board, in place; *thr_v / *thr_g take
// its new row k - 1. Candidates are distinct from each other and from the
// board's real entries. The whole warp calls it.
__device__ __forceinline__ void merge_column(float* col_v, int* col_g,
                                             int k, bool valid, float v,
                                             int g, float* thr_v, int* thr_g,
                                             int lane) {
  const unsigned bal = __ballot_sync(kRoundFull, valid);
  if (bal == 0) return;
  __syncwarp();
  // board entries, from the last 32 up: entry i moves to i + (candidates
  // ahead of it) >= i, into rows already read
  int ahead_b = 0;  // board entries ahead of my candidate
  for (int j = (k - 1) >> 5; j >= 0; --j) {
    const int i = (j << 5) + lane;
    const bool has = i < k;
    const float bv = has ? col_v[i] : 0.f;
    const int bg = has ? col_g[i] : 0;
    int pos = i;
    for (unsigned rest = bal; rest; rest &= rest - 1) {
      const int t = __ffs(rest) - 1;
      const float tv = __shfl_sync(kRoundFull, v, t);
      const int tg = __shfl_sync(kRoundFull, g, t);
      pos += has && rank_before(tv, tg, bv, bg);
      const unsigned m = __ballot_sync(
          kRoundFull, has && rank_before(bv, bg, tv, tg));
      if (lane == t) ahead_b += __popc(m);
    }
    if (has && pos < k) {
      col_v[pos] = bv;
      col_g[pos] = bg;
      if (pos == k - 1) {
        *thr_v = bv;
        *thr_g = bg;
      }
    }
  }
  int ahead_c = 0;  // candidates ahead of mine
  for (unsigned rest = bal; rest; rest &= rest - 1) {
    const int t = __ffs(rest) - 1;
    const float tv = __shfl_sync(kRoundFull, v, t);
    const int tg = __shfl_sync(kRoundFull, g, t);
    ahead_c += valid && rank_before(tv, tg, v, g);
  }
  __syncwarp();  // every board row is read before a candidate lands
  const int pos = ahead_b + ahead_c;
  if (valid && pos < k) {
    col_v[pos] = v;
    col_g[pos] = g;
    if (pos == k - 1) {
      *thr_v = v;
      *thr_g = g;
    }
  }
  __syncwarp();
}

// Pass 1. Warp w marks, for its lane's columns c = 2 lane and 2 lane + 1
// (those < n_mine), which of its rows w + 16 j (j < 32, row < n_rows) rank
// before (thr_v[c], thr_g[c]), the row's entry being (value_of(row,
// acc[row][c]), id_of(row)); masks[w * 64 + c] gets bit j. Rows from
// n_rows on are never marked. The caller puts a barrier before pass 2.
template <typename ValueOf, typename IdOf>
__device__ __forceinline__ void fold_mark(const float* acc, int n_rows,
                                          int n_mine, const float* thr_v,
                                          const int* thr_g, ValueOf value_of,
                                          IdOf id_of, unsigned* masks) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float2* acc2 = reinterpret_cast<const float2*>(acc);
  const int c = 2 * lane;
  const float tv0 = thr_v[c], tv1 = thr_v[c + 1];
  const int tg0 = thr_g[c], tg1 = thr_g[c + 1];
  const bool live0 = c < n_mine, live1 = c + 1 < n_mine;
  unsigned m0 = 0, m1 = 0;
  for (int j = 0; j < 32; ++j) {
    const int row = warp + (j << 4);
    if (row >= n_rows) break;                       // warp-uniform
    const float2 a = acc2[row * (kRoundCols / 2) + lane];
    const int id = id_of(row);
    if (live0 && rank_before(value_of(row, a.x), id, tv0, tg0))
      m0 |= 1u << j;
    if (live1 && rank_before(value_of(row, a.y), id, tv1, tg1))
      m1 |= 1u << j;
  }
  masks[warp * kRoundCols + c] = m0;
  masks[warp * kRoundCols + c + 1] = m1;
}

// Pass 2. Warp w merges the marked rows of columns kFoldWarpCols w ..
// kFoldWarpCols (w + 1) - 1 (those < n_mine), 32 at a time, into board
// column c at (board_v + c k, board_g + c k), keeping thr_v[c] / thr_g[c]
// its row k - 1. The caller puts a barrier after it.
template <typename ValueOf, typename IdOf>
__device__ __forceinline__ void fold_merge(const float* acc,
                                           const unsigned* masks, int n_mine,
                                           int k, float* board_v,
                                           int* board_g, float* thr_v,
                                           int* thr_g, ValueOf value_of,
                                           IdOf id_of) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int cc = 0; cc < kFoldWarpCols; ++cc) {
    const int c = warp * kFoldWarpCols + cc;
    if (c >= n_mine) break;                         // warp-uniform
    const unsigned mk = lane < kRoundWarps ? masks[lane * kRoundCols + c]
                                           : 0u;
    const int cnt = __popc(mk);
    int incl = cnt;                                 // marked rows of warps
#pragma unroll                                      // 0 .. lane
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kRoundFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int excl = incl - cnt;
    const int total = __shfl_sync(kRoundFull, incl, 31);
    for (int t0 = 0; t0 < total; t0 += 32) {
      const int t = t0 + lane;                      // my candidate
      int o = 0;                    // its warp: the last o with excl <= t
#pragma unroll
      for (int q = 1; q < kRoundWarps; ++q)
        if (__shfl_sync(kRoundFull, excl, q) <= t) o = q;
      const unsigned mo = __shfl_sync(kRoundFull, mk, o);
      const int eo = __shfl_sync(kRoundFull, excl, o);
      bool valid = t < total;
      float v = 0.f;
      int g = 0;
      if (valid) {
        const int row = o + (nth_set_bit(mo, t - eo) << 4);
        v = value_of(row, acc[row * kRoundCols + c]);
        g = id_of(row);
        // an earlier merge may have raised the threshold past it
        valid = rank_before(v, g, thr_v[c], thr_g[c]);
      }
      merge_column(board_v + static_cast<size_t>(c) * k,
                   board_g + static_cast<size_t>(c) * k, k, valid, v, g,
                   thr_v + c, thr_g + c, lane);
    }
  }
}

// The fold of a block's only window into its empty board, for k <=
// n_rows <= kFoldRows: the column's first k rows in (value desc, row asc)
// order, a row's value being value_of(row, acc[row][c]). Pass p stages
// board rows r0 = p kSelectK .. r0 + kp - 1 (kp <= kSelectK), values
// stv[r * 64 + c] and rows stg[r * 64 + c] for r < kp, and then calls
// emit(r0, kp) from the whole CTA. `scratch` holds kSelectScratchBytes
// (8-byte aligned). stv / stg may lie over acc: acc is read into
// registers before the barrier that precedes the first write. The
// accumulator's sums are never -0.0 (they start at +0.0, and a
// round-to-nearest sum is -0.0 only when both terms are), so a value read
// back from its key is the accumulator's bit for bit. Called by the whole
// CTA; a barrier precedes every emit.
template <typename ValueOf, typename Emit>
__device__ __forceinline__ void fold_select(const float* acc, int n_rows,
                                            int k, ValueOf value_of,
                                            unsigned char* scratch,
                                            float* stv, int* stg,
                                            Emit emit) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* cnt = reinterpret_cast<int*>(scratch);                  // [16][64]
  unsigned* tmask = reinterpret_cast<unsigned*>(
      cnt + kRoundWarps * kRoundCols);                         // [16][64]
  unsigned* kth = tmask + kRoundWarps * kRoundCols;            // [64]
  int* n_above = reinterpret_cast<int*>(kth + kRoundCols);     // [64]
  unsigned long long* list = reinterpret_cast<unsigned long long*>(
      n_above + kRoundCols);                                   // [64][Ld]

  // my rows' keys, two columns (0: below every real row's key)
  const float2* acc2 = reinterpret_cast<const float2*>(acc);
  unsigned key0[32], key1[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int row = warp + (j << 4);
    key0[j] = 0u;
    key1[j] = 0u;
    if (row < n_rows) {
      const float2 a = acc2[row * (kRoundCols / 2) + lane];
      key0[j] = order_key(value_of(row, a.x));
      key1[j] = order_key(value_of(row, a.y));
    }
  }
  for (int r0 = 0; r0 < k; r0 += kSelectK) {
    const int kp = min(kSelectK, k - r0);
    if (r0 > 0) __syncthreads();          // emit has read the stage
    // the kp-th key of each column: the largest t with at least kp keys
    // >= t, one bit a round from the top
    if (tid < kRoundCols) kth[tid] = 0u;
    unsigned t0 = 0u, t1 = 0u;
    for (int bit = 31; bit >= 0; --bit) {
      const unsigned c0 = t0 | (1u << bit), c1 = t1 | (1u << bit);
      int n0 = 0, n1 = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        n0 += key0[j] >= c0;
        n1 += key1[j] >= c1;
      }
      cnt[warp * kRoundCols + 2 * lane] = n0;
      cnt[warp * kRoundCols + 2 * lane + 1] = n1;
      __syncthreads();
      if (tid < kRoundCols) {
        int n = 0;
#pragma unroll
        for (int w = 0; w < kRoundWarps; ++w) n += cnt[w * kRoundCols + tid];
        if (n >= kp) kth[tid] |= 1u << bit;
      }
      __syncthreads();
      t0 = kth[2 * lane];
      t1 = kth[2 * lane + 1];
    }
    // rows above the kp-th key (fewer than kp a column) and rows at it
    int g0 = 0, g1 = 0;
    unsigned m0 = 0u, m1 = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      g0 += key0[j] > t0;
      g1 += key1[j] > t1;
      m0 |= static_cast<unsigned>(key0[j] == t0) << j;
      m1 |= static_cast<unsigned>(key1[j] == t1) << j;
    }
    cnt[warp * kRoundCols + 2 * lane] = g0;
    cnt[warp * kRoundCols + 2 * lane + 1] = g1;
    tmask[warp * kRoundCols + 2 * lane] = m0;
    tmask[warp * kRoundCols + 2 * lane + 1] = m1;
    __syncthreads();
    if (tid < kRoundCols) {
      int n = 0;
      for (int w = 0; w < kRoundWarps; ++w) n += cnt[w * kRoundCols + tid];
      n_above[tid] = n;
    }
    // the column lists of the rows above: (key, ~row), distinct, so that
    // one unsigned compare is rank_before
    int o0 = 0, o1 = 0;                     // warps before mine
    for (int w = 0; w < warp; ++w) {
      o0 += cnt[w * kRoundCols + 2 * lane];
      o1 += cnt[w * kRoundCols + 2 * lane + 1];
    }
    unsigned long long* l0 = list + (2 * lane) * kSelectLd;
    unsigned long long* l1 = l0 + kSelectLd;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const unsigned lo = ~static_cast<unsigned>(warp + (j << 4));
      if (key0[j] > t0)
        l0[o0++] = (static_cast<unsigned long long>(key0[j]) << 32) | lo;
      if (key1[j] > t1)
        l1[o1++] = (static_cast<unsigned long long>(key1[j]) << 32) | lo;
    }
    __syncthreads();                        // the lists are complete

    // an entry's rank: the entries above it; 8 threads a column, 4 entries
    // a pass
    {
      const int c = tid >> 3, sub = tid & 7;
      const int a = n_above[c];
      const unsigned long long* lc = list + c * kSelectLd;
      for (int e0 = sub; e0 < a; e0 += 32) {
        unsigned long long p[4];
        int r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = e0 + 8 * i < a ? lc[e0 + 8 * i] : ~0ull;
          r[i] = 0;
        }
        for (int f = 0; f < a; ++f) {
          const unsigned long long q = lc[f];
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i] += q > p[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (e0 + 8 * i < a) {
            stv[r[i] * kRoundCols + c] =
                key_value(static_cast<unsigned>(p[i] >> 32));
            stg[r[i] * kRoundCols + c] = static_cast<int>(
                ~static_cast<unsigned>(p[i]));
          }
        }
      }
    }
    // the rows at the kp-th key, in row order (row = warp + 16 j: j major,
    // warp minor), after the rows above, as many as kp needs
    unsigned taken0 = 0u, taken1 = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * lane + h;
      const int a = n_above[c];
      const float tv = key_value(h ? t1 : t0);
      for (unsigned m = h ? m1 : m0; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const unsigned below = (1u << j) - 1u;
        int tr = 0;                       // rows at the kp-th key before it
        for (int w = 0; w < kRoundWarps; ++w) {
          const unsigned mw = tmask[w * kRoundCols + c];
          tr += __popc(mw & below) + (w < warp ? (mw >> j) & 1u : 0u);
        }
        if (a + tr >= kp) break;            // later rows rank later still
        stv[(a + tr) * kRoundCols + c] = tv;
        stg[(a + tr) * kRoundCols + c] = warp + (j << 4);
        (h ? taken1 : taken0) |= 1u << j;
      }
    }
    __syncthreads();                      // the staged board is complete
    emit(r0, kp);
    // the pass's rows leave the keys: 0 ranks below every row
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (key0[j] > t0 || ((taken0 >> j) & 1u)) key0[j] = 0u;
      if (key1[j] > t1 || ((taken1 >> j) & 1u)) key1[j] = 0u;
    }
  }
}

}  // namespace bm25
