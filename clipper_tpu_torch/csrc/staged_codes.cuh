// Staged [M; C] codes of the one-pass builds: the 64 x 64 tiling, the
// shared-memory form of a tile's codes, the closed-form walk over
// unordered tile pairs and the 16-byte write of a staged tile. Shared by
// the stacked build (stored_build.cu, kernel 4) and the flat-triangle
// builds (tri_pair_build.cuh: tri_build.cu and tri_build_fused.cu,
// kernels 2 and 8).
//
// A staged value is M's code with C's in its top bit, which M's own never
// sets (M >= 0: an int8 code in 0..127, or a bf16 of sign 0), so one
// shared-memory byte (int8) or half-word (bf16) carries both halves of an
// entry until the write splits them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  static constexpr int kRowBytes = kTile * (int)sizeof(T);
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kBytes = kTile * kPitch;
  static constexpr int kChunk = 16 / (int)sizeof(T);  // values a chunk
  static constexpr int kWords = kStep * (int)sizeof(T) / 4;  // of a step
  static constexpr uint32_t kFlag = sizeof(T) == 1 ? 0x80u : 0x8000u;
  // of a word: M's bits, C's flags at bit 0 of each value, C's code (127,
  // or bf16 1.0) when kept
  static constexpr uint32_t kMask = sizeof(T) == 1 ? 0x7f7f7f7fu : 0x7fff7fffu;
  static constexpr uint32_t kLsb = sizeof(T) == 1 ? 0x01010101u : 0x00010001u;
  static constexpr int kShift = sizeof(T) == 1 ? 7 : 15;
  static constexpr uint32_t kOne = sizeof(T) == 1 ? 0x7fu : 0x3f80u;
};

__device__ __forceinline__ uint32_t bits_of(int8_t v) {
  return (uint32_t)(uint8_t)v;
}
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return (uint32_t)__bfloat16_as_ushort(v);
}
__device__ __forceinline__ void from_bits(int8_t* d, uint32_t b) {
  *d = (int8_t)b;
}
__device__ __forceinline__ void from_bits(__nv_bfloat16* d, uint32_t b) {
  *d = __ushort_as_bfloat16((unsigned short)b);
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
// kThreads) on consecutive chunks of a row; vec: every chunk of the
// target is one aligned 16-byte store (16-byte aligned M, C and rows, and
// cols a multiple of a chunk), else value by value. kStream: the 16-byte
// stores are evicted first (store16).
template <typename T, bool kStream = false>
__device__ __forceinline__ void write_staged(const uint8_t* src, T* M, T* C,
                                             size_t ld, int rows, int cols,
                                             bool vec, int tid) {
  using St = Staged<T>;
  constexpr int kChunks = kTile / St::kChunk;  // chunks a row
  for (int q = tid; q < kTile * kChunks; q += kThreads) {
    const int i = q / kChunks, c = (q % kChunks) * St::kChunk;
    if (i >= rows || c >= cols) continue;
    const uint8_t* s = src + i * St::kPitch + c * (int)sizeof(T);
    const size_t at = (size_t)i * ld + c;
    if (vec) {
      const uint4 x = *reinterpret_cast<const uint4*>(s);
      store16<kStream>(M + at, make_uint4(x.x & St::kMask, x.y & St::kMask,
                                          x.z & St::kMask, x.w & St::kMask));
      store16<kStream>(C + at,
                       make_uint4(((x.x >> St::kShift) & St::kLsb) * St::kOne,
                                  ((x.y >> St::kShift) & St::kLsb) * St::kOne,
                                  ((x.z >> St::kShift) & St::kLsb) * St::kOne,
                                  ((x.w >> St::kShift) & St::kLsb) *
                                      St::kOne));
    } else {
      for (int e = 0; e < St::kChunk && c + e < cols; ++e) {
        const uint32_t b = sizeof(T) == 1
            ? (uint32_t)s[e]
            : (uint32_t)reinterpret_cast<const uint16_t*>(s)[e];
        from_bits(M + at + e, b & ~St::kFlag);
        from_bits(C + at + e, (b & St::kFlag) ? St::kOne : 0u);
      }
    }
  }
}

}  // namespace
