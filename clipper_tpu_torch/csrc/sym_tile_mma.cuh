// Shared tile arithmetic of the two symmetric-triangle dual matvecs:
// sym_rows_matvec.cu (row-chunked storage) and sym_tiles_matvec.cu (the
// tile list). Both apply stored (2t, t) [M; C] tiles to the K <= 16
// candidate rows U (K, m), forward (the tile's rows are outputs) or
// transposed (its columns are outputs), and differ only in where a tile sits
// and in which order an output block visits its tiles.
//
// int8 and bf16 tiles (t = 128): each tile is staged into shared memory
// with 16-byte cp.async copies, rows padded by 16 bytes so the fragment
// reads hit distinct banks (an int8 stage is 36 KB, a bf16 one 68 KB; two
// stages fit either way), and contracted with mma.sync.m16n8k16 (bf16 in,
// f32 accumulate; U rows >= K read as zero). The int8 codes 0..127 become
// bf16 exactly by a bias trick (codes_bf16x2); bf16 fragments are pairs of
// staged values, with no conversion. Every tile's 8 mma steps start
// from zero and the f32 tile partials are summed in f64 by the caller: the
// result is the exact sum to within the partials' rounding, rounded once.
//
// float / double tiles: one thread per output column, K f64 sums in
// registers, on CUDA cores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace symtile {

constexpr int kT = 128;             // the tensor-core kernels' tile
constexpr int kStages = 2;          // tiles in shared memory: 1 in flight
constexpr int kThreads = 256;
constexpr int kNtw = kT / 32;       // n-tiles of 8 output columns per warp
constexpr int kMaxK = 16;           // candidate rows a block takes

using bf16mma::codes_bf16x2;
using bf16mma::mma_bf16;

// a staged (2T, T) tile of storage type S: rows padded by 16 bytes
template <typename S>
struct TileStage {
  static constexpr int kLd = kT * (int)sizeof(S) + 16;  // bytes a row
  static constexpr int kBytes = 2 * kT * kLd;
};

// two adjacent codes (a little-endian uint16) -> bf16x2
__device__ __forceinline__ uint32_t i8pair(uint16_t two) {
  return codes_bf16x2(__byte_perm((uint32_t)two, 0u, 0x4140));
}

// codes lo and hi from two smem bytes -> bf16x2 (lo in the low half)
__device__ __forceinline__ uint32_t i8bytes(int8_t lo, int8_t hi) {
  return codes_bf16x2((uint32_t)(uint8_t)lo | ((uint32_t)(uint8_t)hi << 16));
}

__device__ __forceinline__ uint32_t load_u2(const __nv_bfloat16* u, int row,
                                            int K, int m, int col) {
  if (row >= K) return 0u;
  return __ldg(reinterpret_cast<const unsigned int*>(u + (size_t)row * m + col));
}

// A fragment of m16n8k16: rows g and g+8, columns col + 2 tig (+1) and +8.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* u,
                                       int K, int m, int g, int tig, int col) {
  const int cc = col + 2 * tig;
  a[0] = load_u2(u, g, K, m, cc);
  a[1] = load_u2(u, g + 8, K, m, cc);
  a[2] = load_u2(u, g, K, m, cc + 8);
  a[3] = load_u2(u, g + 8, K, m, cc + 8);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// copy the (2T, T) tile of S (global row stride ld elements) into a
// padded smem tile
template <typename S>
__device__ __forceinline__ void stage_tile(int8_t* dst, const S* src,
                                           size_t ld) {
  constexpr int kSegsPerRow = kT * (int)sizeof(S) / 16;
  constexpr int kSegs = 2 * kT * kSegsPerRow;  // 16-byte segments a tile
#pragma unroll
  for (int i = 0; i < kSegs / kThreads; ++i) {
    const int s = threadIdx.x + i * kThreads;
    const int row = s / kSegsPerRow;
    const int col = (s % kSegsPerRow) * 16;
    cp_async16(dst + row * TileStage<S>::kLd + col,
               reinterpret_cast<const int8_t*>(src + (size_t)row * ld) + col);
  }
}

// One staged int8 tile applied to u's block ub into part (zeroed here).
// 8 warps; warp w owns output columns o in [w T/4, (w+1) T/4) of the
// block's 2T (o < T: M half, o >= T: C half). Forward: the tile's row o
// contracts u[ub T : ub T + T]. Transposed: the tile's column o % T of half
// o / T contracts u's block ub along the tile's rows.
__device__ __forceinline__ void apply_tile_int8(
    float (&part)[kNtw][4], const int8_t* tile, const __nv_bfloat16* U, int K,
    int m, int g, int tig, int o_base, bool fwd, int ub) {
  constexpr int kLd = TileStage<int8_t>::kLd;
#pragma unroll
  for (int nn = 0; nn < kNtw; ++nn)
    part[nn][0] = part[nn][1] = part[nn][2] = part[nn][3] = 0.f;
  if (fwd) {
    for (int ks = 0; ks < kT / 16; ++ks) {
      uint32_t a[4];
      load_a(a, U, K, m, g, tig, ub * kT + ks * 16);
#pragma unroll
      for (int nn = 0; nn < kNtw; ++nn) {
        const int8_t* p = tile + (o_base + nn * 8 + g) * kLd + ks * 16 +
                          2 * tig;
        const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
        const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + 8);
        mma_bf16(part[nn], a, i8pair(lo), i8pair(hi));
      }
    }
  } else {
    for (int ks = 0; ks < kT / 16; ++ks) {
      uint32_t a[4];
      load_a(a, U, K, m, g, tig, ub * kT + ks * 16);
#pragma unroll
      for (int nn = 0; nn < kNtw; ++nn) {
        const int o = o_base + nn * 8;
        const int h = o / kT;
        const int l = o % kT + g;
        const int8_t* p = tile + (h * kT + ks * 16 + 2 * tig) * kLd + l;
        mma_bf16(part[nn], a, i8bytes(p[0], p[kLd]),
                 i8bytes(p[8 * kLd], p[9 * kLd]));
      }
    }
  }
}

// The same for a staged bf16 tile: fragments are pairs of staged values.
__device__ __forceinline__ void apply_tile_bf16(
    float (&part)[kNtw][4], const int8_t* tile, const __nv_bfloat16* U, int K,
    int m, int g, int tig, int o_base, bool fwd, int ub) {
  constexpr int kLd = TileStage<__nv_bfloat16>::kLd;
#pragma unroll
  for (int nn = 0; nn < kNtw; ++nn)
    part[nn][0] = part[nn][1] = part[nn][2] = part[nn][3] = 0.f;
  if (fwd) {
    for (int ks = 0; ks < kT / 16; ++ks) {
      uint32_t a[4];
      load_a(a, U, K, m, g, tig, ub * kT + ks * 16);
#pragma unroll
      for (int nn = 0; nn < kNtw; ++nn) {
        const int8_t* p = tile + (o_base + nn * 8 + g) * kLd +
                          2 * (ks * 16 + 2 * tig);
        mma_bf16(part[nn], a, *reinterpret_cast<const uint32_t*>(p),
                 *reinterpret_cast<const uint32_t*>(p + 16));
      }
    }
  } else {
    for (int ks = 0; ks < kT / 16; ++ks) {
      uint32_t a[4];
      load_a(a, U, K, m, g, tig, ub * kT + ks * 16);
#pragma unroll
      for (int nn = 0; nn < kNtw; ++nn) {
        const int o = o_base + nn * 8;
        const int h = o / kT;
        const int l = o % kT + g;
        const uint16_t* p = reinterpret_cast<const uint16_t*>(
            tile + (h * kT + ks * 16 + 2 * tig) * kLd + 2 * l);
        constexpr int kRow = kLd / 2;  // a row in 16-bit units
        mma_bf16(part[nn], a, (uint32_t)p[0] | ((uint32_t)p[kRow] << 16),
                 (uint32_t)p[8 * kRow] | ((uint32_t)p[9 * kRow] << 16));
      }
    }
  }
}

// the tile applier of storage type S
template <typename S>
__device__ __forceinline__ void apply_tile(
    float (&part)[kNtw][4], const int8_t* tile, const __nv_bfloat16* U, int K,
    int m, int g, int tig, int o_base, bool fwd, int ub) {
  if constexpr (sizeof(S) == 1)
    apply_tile_int8(part, tile, U, K, m, g, tig, o_base, fwd, ub);
  else
    apply_tile_bf16(part, tile, U, K, m, g, tig, o_base, fwd, ub);
}

// Write output block j of the tensor-core kernels' f64 sums: out (K, 2m) row
// major, f32 scaled after one rounding (raw = 0), or the unscaled f64 sums
// (raw = 1) for a caller that reduces them across ranks first.
__device__ __forceinline__ void store_mma(const double (&acc)[kNtw][4],
                                           void* out, int raw, float scale,
                                           int K, int m, int j, int g, int tig,
                                           int o_base) {
  const size_t row_stride = 2 * (size_t)m;
#pragma unroll
  for (int nn = 0; nn < kNtw; ++nn) {
    const int o = o_base + nn * 8 + 2 * tig;
    const int h = o / kT;
    const size_t col = (size_t)h * m + (size_t)j * kT + (o % kT);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = g + 8 * half;
      if (row >= K) continue;
      const size_t at = (size_t)row * row_stride + col;
      const double v0 = acc[nn][2 * half], v1 = acc[nn][2 * half + 1];
      if (raw) {
        static_cast<double*>(out)[at] = v0;
        static_cast<double*>(out)[at + 1] = v1;
      } else {
        static_cast<float*>(out)[at] = (float)v0 * scale;
        static_cast<float*>(out)[at + 1] = (float)v1 * scale;
      }
    }
  }
}

// float / double tiles: output column o (of 2t) of one tile, with global
// row stride ld elements, applied to u's block ub, added to acc[0:K].
template <typename F>
__device__ __forceinline__ void apply_tile_float(double (&acc)[kMaxK],
                                                 const F* tile, size_t ld,
                                                 const F* U, int K, int m,
                                                 int t, int o, bool fwd,
                                                 int ub) {
  const F* u = U + (size_t)ub * t;
  if (fwd) {
    const F* row = tile + (size_t)o * ld;
    for (int q = 0; q < t; ++q) {
      const F s = row[q];
      if (s == F(0)) continue;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k] += (double)s * (double)u[(size_t)k * m + q];
    }
  } else {
    const int h = o / t;
    const F* col = tile + (size_t)(h * t) * ld + (o % t);
    for (int i = 0; i < t; ++i) {
      const F s = col[(size_t)i * ld];
      if (s == F(0)) continue;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k] += (double)s * (double)u[(size_t)k * m + i];
    }
  }
}

// output column o of block j: f32 after one rounding, or the raw f64 sums
__device__ __forceinline__ void store_float(const double (&acc)[kMaxK],
                                            void* out, int raw, int K, int m,
                                            int t, int j, int o) {
  const size_t col = (size_t)(o / t) * m + (size_t)j * t + (o % t);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k >= K) continue;
    const size_t at = (size_t)k * 2 * m + col;
    if (raw)
      static_cast<double*>(out)[at] = acc[k];
    else
      static_cast<float*>(out)[at] = (float)acc[k];
  }
}

}  // namespace symtile
