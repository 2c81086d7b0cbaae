// Single-problem dual matvec over row-chunked symmetric-triangle storage,
// for Hopper.
//
// Replaces the TPU kernel
// clipper_tpu/ops/symstore.py:make_sym_dual_matvec_pallas_rows (Pallas body
// :692-732, launch :754-765).
//
// What it computes. Storage is (NC, 2t, G t): row block r's upper tiles
// (r, r..nt-1) sit in ceil((nt - r) / G) consecutive chunks of G tiles side
// by side; in each chunk rows 0:t hold M's tiles, rows t:2t C's, and a
// short row's pad tiles are zero. Row r's first chunk is
//   first(r) = S(nt) - S(nt - r),  S(n) = G q (q + 1) / 2 + (n - q G)(q + 1),
// q = n / G (ops/symstore.py:row_first_chunk), so tile (r, c), c >= r, sits
// in chunk first(r) + (c - r) / G at lanes ((c - r) % G) t. Given the K <= 16
// candidate rows U (K, m), the kernel writes out = [M U'; C U']' as (K, 2m)
// f32: for every output row block j, the forward products of tiles
// (j, c >= j) and the transposed products of tiles (r < j, j). The diagonal
// tile holds the full symmetric tile and is applied forward only (the
// masked transpose at symstore.py:723-724).
//
// What bounds it on this card. At m = 65,536 (t = 128, G = 32, K = 16) the
// stored tiles are 131,328 x 32 KB = 4.30 GB; reading them once takes
// 1.28 ms at 3.35 TB/s, and u (2 MB) and out (8 MB) add little. The
// products are 4 m^2 K = 2.7e11 bf16 flops, 0.28 ms at 989 TFLOP/s. It is
// bound by bytes.
//
// Design. CUDA blocks run in no order and this port keeps no float atomics
// (a rerun must reproduce a trajectory bit for bit), so the TPU's
// accumulation across a sequential grid becomes one block per output row
// block j that owns its outputs outright. The block walks exactly nt tiles
// in a fixed order: row j's tiles forward (c = j..nt-1, contiguous from
// first(j)), then column j's tiles transposed (r = 0..j-1). Its addresses
// come from the closed form above: the TPU's row table and in-kernel binary
// search were an SMEM workaround and are gone, and pad tiles are never
// read. Each (2t, t) int8 tile is staged into shared memory with 16-byte
// cp.async copies, double-buffered so the next tile loads while this one
// is applied (a third buffer measured no faster), and rows are padded to
// t + 16 bytes so the fragment reads hit distinct banks. The K candidate
// rows are the 16-row A operand of mma.sync.m16n8k16 (bf16 in, f32
// accumulate; rows >= K read as zero, which serves the K = 1 init calls);
// int8 codes convert to bf16 exactly (codes_bf16x2, at full rate), so the
// products are the JAX kernel's. Every off-diagonal tile is read
// twice per call (by block r forward and block c transposed), so expect
// about 2x the byte bound; the one-read design and TMA / wgmma staging are
// later work. Chunk and tile offsets are 64-bit: the m = 65,536 storage is
// 4.56 GB.
//
// Summation. An output at m = 65,536 sums 512 tiles; a long f32 running
// sum (and the tensor cores truncate each mma's sum) drifted 8.5e-3 from
// the plain version on outputs near 70, where 1e-4 is about 10 ulps. So
// each tile's 8 mma steps start from zero, and the f32 tile partials are
// added in f64 registers: the
// result is the exact sum to within the tile partials' rounding, rounded
// once to f32 (the JAX kernel's f32 result type) and scaled in f32, as the
// plain version does. The JAX kernel keeps an f32 accumulator instead, so
// this kernel is the more exact of the two (ROADMAP.md Queue 3).
//
// The float / double storage kinds take a plain CUDA-core kernel with the
// same tile order, summing in f64 and rounding to f32 as well.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 128;             // the int8 kernel's tile
constexpr int kLds = kT + 16;       // padded shared-memory row, bytes
constexpr int kTileSmem = 2 * kT * kLds;
constexpr int kStages = 2;          // tiles in shared memory: 1 in flight
constexpr int kThreads = 256;

__device__ __forceinline__ long long tri_chunks_below(long long n, int G) {
  const long long q = n / G;
  return (long long)G * q * (q + 1) / 2 + (n - q * G) * (q + 1);
}

// first chunk of row block r
__device__ __forceinline__ long long first_chunk(int r, int nt, int G) {
  return tri_chunks_below(nt, G) - tri_chunks_below(nt - r, G);
}

// element offset of tile (r, c), c >= r, and its row stride G t
__device__ __forceinline__ size_t tile_offset(int r, int c, int nt, int t,
                                              int G) {
  const long long k = first_chunk(r, nt, G) + (c - r) / G;
  return (size_t)k * (size_t)(2 * t) * (size_t)(G * t) +
         (size_t)((c - r) % G) * (size_t)t;
}

// Two int8 codes in 0..127 (the quantizer's range: M in 0..127, C 0 or
// 127), in bytes 0 and 2 of w, as bf16x2 (byte 0 in the low half). The
// bf16 bits 0x4300 | x are 128 + x exactly (ulp 1 in [128, 256)), and the
// bf16 subtraction of 128 is exact: one OR and one HSUB2 at full rate,
// where the int -> float -> bf16 conversions run at a quarter rate.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w) {
  const uint32_t biased = w | 0x43004300u;
  const uint32_t bias = 0x43004300u;
  __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&bias);
  a = __hsub2(a, b);
  return *reinterpret_cast<uint32_t*>(&a);
}

// two adjacent codes (a little-endian uint16) -> bf16x2
__device__ __forceinline__ uint32_t i8pair(uint16_t two) {
  return codes_bf16x2(__byte_perm((uint32_t)two, 0u, 0x4140));
}

// codes lo and hi from two smem bytes -> bf16x2 (lo in the low half)
__device__ __forceinline__ uint32_t i8bytes(int8_t lo, int8_t hi) {
  return codes_bf16x2((uint32_t)(uint8_t)lo | ((uint32_t)(uint8_t)hi << 16));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// tile `it` of block j's walk: forward tiles (j, j + it) first, then the
// transposed tiles (it - (nt - j), j)
__device__ __forceinline__ void walk(int it, int j, int nt, int& r, int& c,
                                     bool& fwd) {
  fwd = it < nt - j;
  r = fwd ? j : it - (nt - j);
  c = fwd ? j + it : j;
}

// copy the (2T, T) int8 tile (row stride Gt) into a padded smem tile
__device__ __forceinline__ void stage_tile(int8_t* dst, const int8_t* src,
                                           int Gt) {
  constexpr int kSegs = 2 * kT * kT / 16;    // 16-byte segments per tile
  constexpr int kSegsPerRow = kT / 16;
#pragma unroll
  for (int i = 0; i < kSegs / kThreads; ++i) {
    const int s = threadIdx.x + i * kThreads;
    const int row = s / kSegsPerRow;
    const int col = (s % kSegsPerRow) * 16;
    cp_async16(dst + row * kLds + col, src + (size_t)row * Gt + col);
  }
}

// 8 warps; warp w owns output columns o in [w T/4, (w+1) T/4) of the
// block's 2T (o < T: M half, o >= T: C half).
__global__ void __launch_bounds__(kThreads, 2) sym_rows_int8_kernel(
    const int8_t* __restrict__ chunks, const __nv_bfloat16* __restrict__ U,
    float* __restrict__ out, int K, int nt, int G, float scale) {
  extern __shared__ __align__(16) int8_t smem[];
  constexpr int NTW = kT / 32;  // n-tiles of 8 columns per warp
  const int j = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m = nt * kT;
  const int Gt = G * kT;
  const int o_base = warp * NTW * 8;

  double acc[NTW][4];
#pragma unroll
  for (int nn = 0; nn < NTW; ++nn)
    acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.0;

  int r, c;
  bool fwd;
  // cp.async group g carries tile g (groups past the walk's end are empty)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nt) {
      walk(s, j, nt, r, c, fwd);
      stage_tile(smem + s * kTileSmem, chunks + tile_offset(r, c, nt, kT, G),
                 Gt);
    }
    cp_async_commit();
  }

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kStages - 2>();      // tile it has landed
    __syncthreads();                   // ... for every thread, and tile
                                       // it - 1's buffer is free again
    const int next = it + kStages - 1;
    if (next < nt) {
      walk(next, j, nt, r, c, fwd);
      stage_tile(smem + (next % kStages) * kTileSmem,
                 chunks + tile_offset(r, c, nt, kT, G), Gt);
    }
    cp_async_commit();
    walk(it, j, nt, r, c, fwd);
    const int8_t* tile = smem + (it % kStages) * kTileSmem;
    float part[NTW][4];
#pragma unroll
    for (int nn = 0; nn < NTW; ++nn)
      part[nn][0] = part[nn][1] = part[nn][2] = part[nn][3] = 0.f;
    if (fwd) {
      // tile (j, c) applied to u's block c: storage rows are outputs
      for (int ks = 0; ks < kT / 16; ++ks) {
        uint32_t a[4];
        load_a(a, U, K, m, g, tig, c * kT + ks * 16);
#pragma unroll
        for (int nn = 0; nn < NTW; ++nn) {
          const int8_t* p = tile + (o_base + nn * 8 + g) * kLds + ks * 16 +
                            2 * tig;
          const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
          const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + 8);
          mma_bf16(part[nn], a, i8pair(lo), i8pair(hi));
        }
      }
    } else {
      // tile (r, j) transposed, applied to u's block r
      for (int ks = 0; ks < kT / 16; ++ks) {
        uint32_t a[4];
        load_a(a, U, K, m, g, tig, r * kT + ks * 16);
#pragma unroll
        for (int nn = 0; nn < NTW; ++nn) {
          const int o = o_base + nn * 8;
          const int h = o / kT;
          const int l = o % kT + g;
          const int8_t* p = tile + (h * kT + ks * 16 + 2 * tig) * kLds + l;
          mma_bf16(part[nn], a, i8bytes(p[0], p[kLds]),
                   i8bytes(p[8 * kLds], p[9 * kLds]));
        }
      }
    }
#pragma unroll
    for (int nn = 0; nn < NTW; ++nn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nn][q] += (double)part[nn][q];
  }

  const size_t row_stride = 2 * (size_t)m;
#pragma unroll
  for (int nn = 0; nn < NTW; ++nn) {
    const int o = o_base + nn * 8 + 2 * tig;
    const int h = o / kT;
    const size_t col = (size_t)h * m + (size_t)j * kT + (o % kT);
    if (g < K) {
      out[(size_t)g * row_stride + col] = (float)acc[nn][0] * scale;
      out[(size_t)g * row_stride + col + 1] = (float)acc[nn][1] * scale;
    }
    if (g + 8 < K) {
      out[(size_t)(g + 8) * row_stride + col] = (float)acc[nn][2] * scale;
      out[(size_t)(g + 8) * row_stride + col + 1] = (float)acc[nn][3] * scale;
    }
  }
}

// float / double storage: one thread per output column, K <= 16 f64 sums in
// registers, the same fixed tile order, rounded to f32 at the end.
template <typename F>
__global__ void __launch_bounds__(kThreads) sym_rows_float_kernel(
    const F* __restrict__ chunks, const F* __restrict__ U,
    float* __restrict__ out, int K, int nt, int t, int G) {
  const int j = blockIdx.x;
  const int m = nt * t;
  const size_t Gt = (size_t)G * t;
  for (int o = threadIdx.x; o < 2 * t; o += blockDim.x) {
    const int h = o / t;
    const int l = o % t;
    double acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0.0;
    for (int c = j; c < nt; ++c) {
      const F* row = chunks + tile_offset(j, c, nt, t, G) + (size_t)o * Gt;
      for (int q = 0; q < t; ++q) {
        const F s = row[q];
        if (s == F(0)) continue;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < K)
            acc[k] += (double)s * (double)U[(size_t)k * m + c * t + q];
      }
    }
    for (int r = 0; r < j; ++r) {
      const F* col = chunks + tile_offset(r, j, nt, t, G) +
                     (size_t)(h * t) * Gt + l;
      for (int i = 0; i < t; ++i) {
        const F s = col[(size_t)i * Gt];
        if (s == F(0)) continue;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < K)
            acc[k] += (double)s * (double)U[(size_t)k * m + r * t + i];
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < K)
        out[(size_t)k * 2 * m + (size_t)h * m + (size_t)j * t + l] =
            (float)acc[k];
  }
}

}  // namespace

extern "C" {

// chunks (NC, 2t, G t) int8 codes in 0..127, U (K, m) bf16, out (K, 2m) f32;
// t must be 128.
int sym_rows_matvec_int8(const void* chunks, const void* U, void* out, int K,
                         int nt, int t, int G, float scale, void* stream) {
  if (K < 1 || K > 16 || t != kT || G < 1) return (int)cudaErrorInvalidValue;
  const int smem_bytes = kStages * kTileSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      sym_rows_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  sym_rows_int8_kernel<<<nt, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const int8_t*)chunks, (const __nv_bfloat16*)U, (float*)out, K, nt, G,
      scale);
  return (int)cudaGetLastError();
}

// chunks f32, U (K, m) f32, out (K, 2m) f32.
int sym_rows_matvec_f32(const void* chunks, const void* U, void* out, int K,
                        int nt, int t, int G, void* stream) {
  if (K < 1 || K > 16 || G < 1) return (int)cudaErrorInvalidValue;
  sym_rows_float_kernel<float><<<nt, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)chunks, (const float*)U, (float*)out, K, nt, t, G);
  return (int)cudaGetLastError();
}

// chunks f64, U (K, m) f64, out (K, 2m) f32.
int sym_rows_matvec_f64(const void* chunks, const void* U, void* out, int K,
                        int nt, int t, int G, void* stream) {
  if (K < 1 || K > 16 || G < 1) return (int)cudaErrorInvalidValue;
  sym_rows_float_kernel<double><<<nt, kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)chunks, (const double*)U, (float*)out, K, nt, t, G);
  return (int)cudaGetLastError();
}

}  // extern "C"
