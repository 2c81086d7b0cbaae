// Staged [M; C] values of the one-pass builds: the 64 x 64 tiling, the
// shared-memory form of a tile's values, the closed-form walk over
// unordered tile pairs and the 16-byte write of a staged tile. Shared by
// the stacked build (stored_pair_build.cuh: stored_build.cu, kernel 4, and
// build_probe.cu, kernel 10), the flat-triangle builds
// (tri_pair_build.cuh: tri_build.cu and tri_build_fused.cu, kernels 2
// and 8) and the dense build (affinity_build.cu, kernel 6).
//
// A staged value is M's value with C's flag in its top bit, which M's own
// never sets (M >= 0: an int8 code in 0..127, or a bf16, f32 or f64 of
// sign 0), so one shared-memory byte (int8), half-word (bf16), word (f32)
// or double word (f64) carries both halves of an entry until the write
// splits them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;                           // rows and columns a tile
constexpr int kThreads = 128;                       // one column, 32 rows each
constexpr int kRowsPer = kTile * kTile / kThreads;  // 32
constexpr int kStep = 4;  // rows a step scores (unrolled; the loop is not)

// One staged tile of T: kTile rows of kTile values, rows kPitch bytes
// apart (16 bytes of padding: a row stays 16-byte aligned for the write's
// chunks, and the in-place stores of a warp meet no bank twice).
template <typename T>
struct Staged {
  static constexpr int kSize = (int)sizeof(T);
  using Bits = std::conditional_t<kSize == 8, uint64_t, uint32_t>;
  static constexpr int kRowBytes = kTile * kSize;
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kBytes = kTile * kPitch;
  static constexpr int kChunk = 16 / kSize;         // values a chunk
  static constexpr int kWords = kStep * kSize / 4;  // of a step
  static constexpr Bits kFlag = Bits(1) << (8 * kSize - 1);
  // C's value where kept: 127, or 1.0 in bf16, f32 or f64
  static constexpr Bits kOne = kSize == 1   ? Bits(0x7f)
                               : kSize == 2 ? Bits(0x3f80)
                               : kSize == 4 ? Bits(0x3f800000)
                                            : Bits(0x3ff0000000000000ull);
  // of a 32-bit word of values of at most 4 bytes: M's bits, C's flags at
  // bit 0 of each value, C's value
  static constexpr uint32_t kMask = kSize == 1   ? 0x7f7f7f7fu
                                    : kSize == 2 ? 0x7fff7fffu
                                                 : 0x7fffffffu;
  static constexpr uint32_t kLsb = kSize == 1   ? 0x01010101u
                                   : kSize == 2 ? 0x00010001u
                                                : 1u;
  static constexpr int kShift = kSize == 1 ? 7 : kSize == 2 ? 15 : 31;

  // M's and C's bits of word k of a staged chunk x (an f64 value is two
  // words, its flag in the second)
  static __device__ __forceinline__ uint32_t m_word(uint32_t x, int k) {
    if constexpr (kSize == 8)
      return k % 2 ? x & 0x7fffffffu : x;
    else
      return x & kMask;
  }
  static __device__ __forceinline__ uint32_t c_word(uint32_t x, int k) {
    if constexpr (kSize == 8)
      return k % 2 ? ((x >> 31) & 1u) * 0x3ff00000u : 0u;
    else
      return ((x >> kShift) & kLsb) * (uint32_t)kOne;
  }
  // the staged value e of a row from its bytes s
  static __device__ __forceinline__ Bits value(const uint8_t* s, int e) {
    if constexpr (kSize == 1)
      return s[e];
    else if constexpr (kSize == 2)
      return reinterpret_cast<const uint16_t*>(s)[e];
    else if constexpr (kSize == 4)
      return reinterpret_cast<const uint32_t*>(s)[e];
    else
      return reinterpret_cast<const uint64_t*>(s)[e];
  }
};

__device__ __forceinline__ uint32_t bits_of(int8_t v) {
  return (uint32_t)(uint8_t)v;
}
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}
__device__ __forceinline__ uint32_t bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint64_t bits_of(double v) {
  return (uint64_t)__double_as_longlong(v);
}
__device__ __forceinline__ void from_bits(int8_t* d, uint32_t b) {
  *d = (int8_t)b;
}
__device__ __forceinline__ void from_bits(__nv_bfloat16* d, uint32_t b) {
  *d = __ushort_as_bfloat16((unsigned short)b);
}
__device__ __forceinline__ void from_bits(float* d, uint32_t b) {
  *d = __uint_as_float(b);
}
__device__ __forceinline__ void from_bits(double* d, uint64_t b) {
  *d = __longlong_as_double((long long)b);
}

// Unordered tile pair k of n x n tiles, row-major over I <= J: row I of
// the upper triangle starts at off(I) = I n - I (I - 1) / 2, so I is the
// largest with off(I) <= k, the floor of ((2n + 1) - sqrt((2n + 1)^2 -
// 8k)) / 2, corrected by one step where the square root rounds across an
// integer.
__device__ __forceinline__ int2 tile_pair(int k, int n) {
  const double b = 2.0 * n + 1.0;
  int I = (int)((b - sqrt(b * b - 8.0 * k)) * 0.5);
  if (I * n - I * (I - 1) / 2 > k)
    --I;
  else if ((I + 1) * n - (I + 1) * I / 2 <= k)
    ++I;
  return make_int2(I, k - (I * n - I * (I - 1) / 2) + I);
}

// a 16-byte store; kStream: marked to be evicted first (st.global.cs)
template <bool kStream>
__device__ __forceinline__ void store16(void* at, uint4 v) {
  if constexpr (kStream)
    __stcs(reinterpret_cast<uint4*>(at), v);
  else
    *reinterpret_cast<uint4*>(at) = v;
}

// The first rows x cols values of a staged tile into M and C (row stride
// ld values), 16 bytes of each a thread, consecutive threads (tid of
// nthreads) on consecutive chunks of a row; vec: every chunk of the
// target is one aligned 16-byte store (16-byte aligned M, C and rows, and
// cols a multiple of a chunk), else value by value. kStream: the 16-byte
// stores are evicted first (store16).
template <typename T, bool kStream = false>
__device__ __forceinline__ void write_staged(const uint8_t* src, T* M, T* C,
                                             size_t ld, int rows, int cols,
                                             bool vec, int tid,
                                             int nthreads = kThreads) {
  using St = Staged<T>;
  constexpr int kChunks = kTile / St::kChunk;  // chunks a row
  for (int q = tid; q < kTile * kChunks; q += nthreads) {
    const int i = q / kChunks, c = (q % kChunks) * St::kChunk;
    if (i >= rows || c >= cols) continue;
    const uint8_t* s = src + i * St::kPitch + c * (int)sizeof(T);
    const size_t at = (size_t)i * ld + c;
    if (vec) {
      const uint4 x = *reinterpret_cast<const uint4*>(s);
      store16<kStream>(M + at, make_uint4(St::m_word(x.x, 0),
                                          St::m_word(x.y, 1),
                                          St::m_word(x.z, 2),
                                          St::m_word(x.w, 3)));
      store16<kStream>(C + at, make_uint4(St::c_word(x.x, 0),
                                          St::c_word(x.y, 1),
                                          St::c_word(x.z, 2),
                                          St::c_word(x.w, 3)));
    } else {
      for (int e = 0; e < St::kChunk && c + e < cols; ++e) {
        const typename St::Bits b = St::value(s, e);
        from_bits(M + at + e, b & ~St::kFlag);
        from_bits(C + at + e,
                  (b & St::kFlag) ? St::kOne : typename St::Bits(0));
      }
    }
  }
}

}  // namespace
