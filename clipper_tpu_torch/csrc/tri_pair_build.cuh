// The [M; C] build body of one pair of 64-row sub-tiles, which
// tri_build.cu (kernel 2, one block per sub-tile pair) and
// tri_build_fused.cu (kernel 8, one block per problem) run over the flat
// triangle's address map, so that their outputs are identical by
// construction, and affinity_build.cu (kernel 6) over the dense (m, m)
// map of its own (dense_pair there).
//
// A problem's flat storage is (2t, S): upper t-tile (r, c) sits at column
// k t (k its index in storage order), rows 0..t-1 of M, t..2t-1 of C.
// Numerics follow the JAX build step by step, because they decide the
// +-1 int8 codes and the 0/127 C codes: the score functor's value s
// (euclid_score.cuh, pointnormal_score.cuh, or a user's score through
// user_score.cuh), then
//   keep = distinct & off-diagonal & row, col < m_true & s > (V)affeps;
// then store_put.cuh's step for the storage type: int8 M = clip(rint(127
// s), 0, 127) (round half to even, as torch.round) and C = 127, or bf16
// M = bf16(s) and C = 1 (flattri.py:529-533 of the JAX package), or the
// dense build's M = s and C = 1 in the score's own type V (f32 or f64,
// affinity_pallas.py:68-81 of the JAX package). The endpoints, the score
// and affeps are in V: f32 for the stored builds, f32 or f64 for the
// dense one.
//
// Each distinct pair is scored once. Every t-tile (any t >= 1 dividing
// m) is cut into q = ceil(t / 64) sub-tiles of 64 rows (the last shorter
// where 64 does not divide t), n = nt q a side, and the unordered pairs
// (I <= J) of sub-tiles are walked by staged_codes.cuh's tile_pair. Pair
// (I, J) lies in upper t-tile (I / q, J / q). Off a diagonal t-tile it is
// scored and written once; inside one (I < J) its transpose, which lies
// in the same t-tile, is written too; a diagonal sub-tile (I = J) scores
// i < j only and writes (i, j) and (j, i), and its diagonal is 0 (keep
// needs off-diagonal). The dense map has no t-tiles: every pair I < J is
// written in place and transposed. This is exact: the score, the distinct
// mask and the quantization are symmetric bit for bit (the coordinate
// differences of one order are the exact negations of the other's; x y
// and y x round alike).
//
// The exact score runs only where it can be non-zero. A unit of 128
// threads (kernels 2 and 8; 512 in kernel 6, 8 rows each) scores a pair of
// sub-tiles, each thread one column and 32 rows, four a step, reading each
// row's endpoints and associations as broadcast 16-byte loads (two in
// f32 and four in f64 for the built-in scores; Ends). A first pass tests the cheap masks (distinct, i < j
// on a diagonal sub-tile, < m_true) and the functor's screen of its gate,
// false only where the gate fails for certain: in f32 from the two squared
// lengths alone (no square root; euclid_score.cuh, screen_sq), in f64 the
// exact gate itself, whose value the pair's stage cell keeps for the
// second pass (kExactScreen). A pair that fails either keeps the stage's
// cleared
// code, M = C = 0 (or gets C's code alone where 0 > affeps keeps a zero
// score); a bit a row marks the rest. A second pass, apart from the
// first's arithmetic, hands the warp's marked pairs out 32 at a time, one
// a lane, in a fixed order (a prefix sum of the lanes' counts by shuffles;
// no atomics), and each lane runs the exact score in stages: the gate (the
// two correctly rounded lengths and their bound; in f64 already run) and,
// where it passes, the tail (exp, the IEEE division and, point-normal, the two acos), reading
// both endpoints of the pair from shared memory. So the exact score's cost
// follows the share of pairs that pass the screen, not the share of warps
// holding one. The stages run the same functions on the same values as
// operator() (built with --fmad=false), so the codes are its codes. Each
// code, with C's in its top bit, is staged in shared memory (and
// transposed where mirrored), then written as 16-byte chunks of M and C,
// consecutive threads on consecutive chunks (staged_codes.cuh's
// write_staged); where rows are of another length the write goes value by
// value.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "staged_codes.cuh"
#include "store_put.cuh"

namespace {

// Where sub-tile pair (I, J) of a problem goes.
struct SubPair {
  int rows, cols;  // rows of sub-tile I, columns of sub-tile J
  int gr0, gc0;    // their first associations
  bool diag;       // I = J
  bool mirror;     // the transpose is stored too (flat: I < J inside one
                   // t-tile; dense: I < J)
  long long at;    // (row 0, column 0) in the problem's M and C halves
  long long at_t;  // (row 0, column 0) of the transpose (mirror only)
};

// Sub-tile pair k of a problem of nt t-tiles a side, q sub-tiles a
// t-tile and n = nt q (ops/flattri.tri_sub_pair mirrors it).
__device__ __forceinline__ SubPair sub_pair(int k, int n, int q, int t,
                                            int nt, long long S) {
  const int2 ij = tile_pair(k, n);
  const int r = ij.x / q, a = ij.x % q, c = ij.y / q, b = ij.y % q;
  SubPair p;
  p.rows = min(kTile, t - a * kTile);
  p.cols = min(kTile, t - b * kTile);
  p.gr0 = r * t + a * kTile;
  p.gc0 = c * t + b * kTile;
  p.diag = ij.x == ij.y;
  p.mirror = r == c && a != b;
  const long long col = (long long)(r * nt - r * (r - 1) / 2 + c - r) * t;
  p.at = (long long)a * kTile * S + col + b * kTile;
  p.at_t = (long long)b * kTile * S + col + a * kTile;
  return p;
}

// How a build keeps endpoints in shared memory: one record a row, of
// kVals values of the score's type V (f32 or f64), 16-byte aligned. A
// score of D values a set has [set 1's D values, set 2's D values, the
// association's two ids as int bits], zeros to the next 16 bytes:
// [x1 y1 z1 x2 y2 z2 a0 a1] for the Euclidean score (D = 3). A pass loads
// kLoad values of a record and hands the screen and the gate set 1's at 0
// and set 2's at kSet2. The score's kTailAt says what its tail reads: 0
// nothing but the gate's value (Euclidean), -1 the pair's records as the
// gate read them (user_score.cuh), 8 a split record: the point-normal
// score (D = 6) keeps its points and ids as the Euclidean's, [x1 y1 z1 x2
// y2 z2 a0 a1], and its normals in a second half the tail alone loads,
// [n1 n2 0 0] (set 1's normal at 8, set 2's at 11).
template <typename Score>
struct Ends {
  using V = typename Score::Value;
  static constexpr int D = Score::D;
  static constexpr bool kSplit = Score::kTailAt > 0;
  static constexpr int kQuad = 16 / (int)sizeof(V);  // values a 16-byte load
  static constexpr int kLoad =
      kSplit ? Score::kTailAt : (2 * D + 2 + kQuad - 1) / kQuad * kQuad;
  static constexpr int kVals = kSplit ? kLoad + 8 : kLoad;
  static constexpr int kSet2 = kSplit ? 3 : D;
  static constexpr int kIds = kSplit ? 6 : 2 * D;
  static_assert(!kSplit || (D == 6 && kLoad == 8),
                "the split record is the point-normal score's");
};

// an association id in a record's slot, as int bits, and back
__device__ __forceinline__ float id_slot(int a, float) {
  return __int_as_float(a);
}
__device__ __forceinline__ double id_slot(int a, double) {
  return __longlong_as_double((long long)a);
}
__device__ __forceinline__ int id_of(float x) { return __float_as_int(x); }
__device__ __forceinline__ int id_of(double x) {
  return (int)__double_as_longlong(x);
}

// Copy rows [g0, g0 + n) of a problem's endpoints (D values each, in
// p1 and p2) and associations (a) into Ends<Score> records at e, one row
// a thread (tid of nthreads).
template <typename Score, typename V>
__device__ __forceinline__ void stage_ends(const V* p1, const V* p2,
                                           const int* a, int g0, int n,
                                           V* e, int tid, int nthreads) {
  using E = Ends<Score>;
  constexpr int D = E::D, R = E::kVals;
  for (int q = tid; q < n; q += nthreads) {
    const size_t g = (size_t)(g0 + q);
    V* r = e + q * R;
    if constexpr (E::kSplit) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        r[k] = p1[g * D + k];
        r[3 + k] = p2[g * D + k];
      }
      r[6] = id_slot(a[g * 2], V());
      r[7] = id_slot(a[g * 2 + 1], V());
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        r[8 + k] = p1[g * D + 3 + k];
        r[11 + k] = p2[g * D + 3 + k];
      }
      r[14] = r[15] = V(0);
    } else {
#pragma unroll
      for (int k = 0; k < D; ++k) {
        r[k] = p1[g * D + k];
        r[D + k] = p2[g * D + k];
      }
      r[2 * D] = id_slot(a[g * 2], V());
      r[2 * D + 1] = id_slot(a[g * 2 + 1], V());
#pragma unroll
      for (int k = 2 * D + 2; k < R; ++k) r[k] = V(0);
    }
  }
}

// A unit's staged codes: [0] in place, [1] transposed.
template <typename T>
struct PairStage {
  uint8_t codes[2][Staged<T>::kBytes];
};

// Zero the unit's staged codes, the in-place half or both, by its threads
// (tid of nthreads). The caller puts a unit barrier between it and
// build_sub_pair.
template <typename T>
__device__ __forceinline__ void clear_stage(PairStage<T>& st, bool both,
                                            int tid,
                                            int nthreads = kThreads) {
  constexpr int kQuads = Staged<T>::kBytes / 16;
  uint4* c = reinterpret_cast<uint4*>(st.codes[0]);
  for (int q = tid; q < (both ? 2 : 1) * kQuads; q += nthreads)
    c[q] = make_uint4(0u, 0u, 0u, 0u);
}

// Zero the chunks of a staged tile that write_staged hands to thread tid,
// after it has written them out: no other thread reads them, so the
// stage is clear for the next pair without a barrier of its own.
template <typename T>
__device__ __forceinline__ void clear_written(uint8_t* src, int tid) {
  using St = Staged<T>;
  constexpr int kChunks = kTile / St::kChunk;
  for (int q = tid; q < kTile * kChunks; q += kThreads)
    *reinterpret_cast<uint4*>(src + q / kChunks * St::kPitch +
                              q % kChunks * 16) = make_uint4(0u, 0u, 0u, 0u);
}

// the barrier of the unit's kN threads (id 0 where a block is one unit)
template <int kN = kThreads>
__device__ __forceinline__ void unit_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kN) : "memory");
}

// N values of a record from shared memory at e into registers at r, as
// 16-byte loads: N / 4 in f32, N / 2 in f64
template <int N>
__device__ __forceinline__ void load_rec(float* r, const float* e) {
  static_assert(N % 4 == 0, "whole 16-byte loads");
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    reinterpret_cast<float4*>(r)[k] = reinterpret_cast<const float4*>(e)[k];
}
template <int N>
__device__ __forceinline__ void load_rec(double* r, const double* e) {
  static_assert(N % 2 == 0, "whole 16-byte loads");
#pragma unroll
  for (int k = 0; k < N / 2; ++k)
    reinterpret_cast<double2*>(r)[k] = reinterpret_cast<const double2*>(e)[k];
}

// the place of the r-th set bit (from 0) of x, which has more than r
__device__ __forceinline__ int nth_bit(uint32_t x, int r) {
  int at = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(x & ((1u << w) - 1u));
    if (r >= c) {
      r -= c;
      x >>= w;
      at += w;
    }
  }
  return at;
}

// Score, stage and write sub-tile pair p. rows, cols: the Ends<Score>
// records of
// its rows and of its columns, in shared memory, kTile records readable
// from each (only the first p.rows and p.cols are read for their values);
// M, C: the problem's M and C halves, rows ld values apart (p.at and
// p.at_t are offsets into both); st: all zero, and no thread still
// reading it, as of the unit's last barrier. Every thread of the unit
// calls it (tid its index in the unit, bar the unit's barrier; kStream:
// write_staged's); it leaves the stage free for the next pair only after
// the caller's next unit_sync. kN: the unit's threads, each taking one
// column and kTile * kTile / kN of its rows (32 in a unit of 128).
template <bool kStream, typename Score, typename T, int kN = kThreads>
__device__ __forceinline__ void build_sub_pair(
    const Score& score, const typename Score::Value* rows,
    const typename Score::Value* cols, const SubPair& p, int lim,
    typename Score::Value affeps, T* __restrict__ M, T* __restrict__ C,
    long long ld, bool vec, PairStage<T>& st, int tid, int bar) {
  using V = typename Score::Value;
  using St = Staged<T>;
  using Bits = typename St::Bits;
  using E = Ends<Score>;
  constexpr int R = E::kVals, L = E::kLoad, S2 = E::kSet2, I2 = E::kIds;
  // an exact screen's value waits in the pair's stage cell, where a code
  // is as wide as the value (the dense build); elsewhere the gate runs
  // again in the second pass
  constexpr bool kExact = Score::kExactScreen && sizeof(T) == sizeof(V);
  constexpr int kRows = kTile * kTile / kN;  // a thread's rows
  static_assert(kRows <= 32 && kRows % kStep == 0,
                "a thread's rows take a bit each of a word, kStep a step");
  const int j = tid % kTile, i0 = tid / kTile * kRows;
  const int lane = tid % 32;
  uint8_t* here = st.codes[0];
  uint8_t* there = p.diag ? st.codes[0] : st.codes[1];
  const bool col_live = j < p.cols && p.gc0 + j < lim;
  // the rows below it are live: in the sub-tile, below m_true, and on a
  // diagonal sub-tile above the diagonal (i < j)
  const int row_lim = min(min(p.rows, lim - p.gr0), p.diag ? j : kTile);
  // the column's record as a pass loads it (its points, or all its
  // values, and its ids), zero past the sub-tile
  V c[L];
#pragma unroll
  for (int k = 0; k < L; ++k) c[k] = V(0);
  if (j < p.cols) load_rec<L>(c, cols + j * R);
  const int ca0 = id_of(c[I2]), ca1 = id_of(c[I2 + 1]);
  // the code of a pair the masks keep whose score is 0: put(keep = 0 >
  // affeps, 0) gives M = 0 and C's code alone
  const Bits zero = V(0) > affeps ? St::kFlag : Bits(0);

  // the first pass: masks and screen; passed: the rows whose pair the
  // screen passed, bit e for row i0 + e. The stage holds 0 (clear_stage),
  // every code that either settles but zero's, and each marked pair's
  // until its exact score stages its code.
  uint32_t passed = 0u;
#pragma unroll 1
  for (int e0 = 0; e0 < kRows; e0 += kStep) {
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const int i = i0 + e0 + k;
      // (rows past p.rows hold stale records, which live rules out)
      V r[L];
      load_rec<L>(r, rows + i * R);
      const bool live = col_live && i < row_lim &&
                        !(id_of(r[I2]) == ca0 || id_of(r[I2 + 1]) == ca1);
      V v;
      const bool pass = live && score.screen(r, c, r + S2, c + S2, v);
      passed |= (uint32_t)pass << (e0 + k);
      // an exact screen's v waits in the pair's own cell for the tail
      if constexpr (kExact)
        if (pass) reinterpret_cast<V*>(here + i * St::kPitch)[j] = v;
      if (zero && live && !pass) {
        T pv;
        from_bits(&pv, zero);
        reinterpret_cast<T*>(here + i * St::kPitch)[j] = pv;
        if (p.diag || p.mirror)
          reinterpret_cast<T*>(there + j * St::kPitch)[i] = pv;
      }
    }
  }

  // the second pass: the warp's marked pairs in order (lane by lane, row
  // by row), 32 at a time; lane x takes number b0 + x, whose owner is the
  // last lane with at most b0 + x marked pairs before it
  if constexpr (kExact) __syncwarp();  // the owners' v
  const int mine = __popc(passed);
  int upto = mine;  // the marked pairs of the lanes up to this one
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, upto, o);
    if (lane >= o) upto += x;
  }
  const int before = upto - mine;
  const int total = __shfl_sync(0xffffffffu, upto, 31);
  const int j0 = j - lane;  // the column of the warp's lane 0
#pragma unroll 1
  for (int b0 = 0; b0 < total; b0 += 32) {
    const int g = b0 + lane;
    int owner = 0;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      if (__shfl_sync(0xffffffffu, before, owner + w) <= g) owner += w;
    const uint32_t bits = __shfl_sync(0xffffffffu, passed, owner);
    const int from = __shfl_sync(0xffffffffu, before, owner);
    if (g >= total) continue;
    const int i = i0 + nth_bit(bits, g - from), jj = j0 + owner;
    // the pair's records as a pass loads them, as 16-byte loads, and a
    // split record's second half where the gate passes; after an exact
    // screen the gate has passed, and v is the pair's staged value
    V ri[L], cj[L];
    V v, s = V(0);
    bool gated;
    if constexpr (kExact) {
      v = reinterpret_cast<const V*>(here + i * St::kPitch)[jj];
      gated = true;
      if constexpr (Score::kTailAt < 0) {  // the tail reads the records
        load_rec<L>(ri, rows + i * R);
        load_rec<L>(cj, cols + jj * R);
      }
    } else {
      load_rec<L>(ri, rows + i * R);
      load_rec<L>(cj, cols + jj * R);
      gated = score.gate(ri, cj, ri + S2, cj + S2, v);
    }
    if (gated) {
      if constexpr (E::kSplit) {
        load_rec<8>(ri, rows + i * R + Score::kTailAt);
        load_rec<8>(cj, cols + jj * R + Score::kTailAt);
      }
      s = score.tail(ri, cj, ri + S2, cj + S2, v);
    }
    const bool keep = s > affeps;
    T mv, cv;
    put(&mv, &cv, keep, s);
    T pv;
    from_bits(&pv, bits_of(mv) | (keep ? St::kFlag : Bits(0)));
    reinterpret_cast<T*>(here + i * St::kPitch)[jj] = pv;
    if (p.diag || p.mirror)
      reinterpret_cast<T*>(there + jj * St::kPitch)[i] = pv;
  }
  unit_sync<kN>(bar);

  write_staged<T, kStream>(here, M + p.at, C + p.at, (size_t)ld, p.rows,
                           p.cols, vec, tid, kN);
  if (p.mirror)
    write_staged<T, kStream>(st.codes[1], M + p.at_t, C + p.at_t,
                             (size_t)ld, p.cols, p.rows, vec, tid, kN);
}

}  // namespace
