// Batched dual matvec over flat upper-triangle pool storage, for Hopper.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:make_tri_pool_matvec
// (Pallas body :184-195, math _seg_matvec_lane :93-149).
//
// What it computes. Storage is (P, 2t, S) with S = t * nt (nt + 1) / 2:
// row-block r's upper tiles (r, r..nt-1) sit side by side at column
// off_r * t, off_r = r nt - r (r - 1) / 2; rows 0:t hold M's tile, rows t:2t
// C's. Lane b reads problem idx[b] and its K candidate rows U[b] (K, m),
// and writes out[b] = [M U^T; C U^T]^T as (K, 2m): for every output
// row-block j, the forward products of tiles (j, c >= j) and the transposed
// products of the strictly-upper tiles (r < j, j).
//
// What bounds it on this card. Each tick reads every lane's whole triangle
// once (B * 2t * S bytes: 168 MB at B=128, m=1024) against 2 K flops per
// stored byte and direction: ~45 flops/byte at K=16, far below the ~295
// flops/byte where the bf16 tensor cores would bind. It is bound by bytes.
//
// Design. One block per (output row-block j, lane b), j fastest, so the
// nt blocks of one lane run together and the second read of each
// off-diagonal tile (forward by block r, transposed by block c) comes from
// L2. Each block loops over the tiles that touch j in a FIXED order (forward
// c = j..nt-1, then transposed r = 0..j-1) and owns its output columns
// outright: no atomics, so a rerun reproduces every lane bit for bit. The
// K <= 16 candidate rows are exactly the 16-row A operand of
// mma.sync.m16n8k16 (bf16 in, f32 accumulate; rows >= K read as zero, which
// serves the K=1 init calls). int8 codes 0..127 convert to bf16 exactly, so
// the products equal the JAX kernel's bf16 x bf16 -> f32 contractions; only
// the summation order differs. Fragments load straight from global memory
// (the transposed fragments are strided bytes): the simple first version,
// with TMA staging and wgmma left to a later change.
//
// The float / double storage kinds take a plain CUDA-core kernel that
// accumulates in the storage type (f64 in f64, as the JAX package does).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t i8pair(uint16_t two) {
  return pack_bf16((float)(int8_t)(two & 0xff), (float)(int8_t)(two >> 8));
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

__device__ __forceinline__ int tile_offset(int r, int nt) {
  return r * nt - r * (r - 1) / 2;
}

// T: storage tile. 8 warps; warp w owns output columns o in
// [w T/4, (w+1) T/4) of the block's 2T (o < T: M half, o >= T: C half).
template <int T>
__global__ void __launch_bounds__(256) tri_matvec_int8_kernel(
    const int8_t* __restrict__ tri, const int* __restrict__ idx,
    const __nv_bfloat16* __restrict__ U, float* __restrict__ out, int K,
    int nt, long long S, float scale) {
  constexpr int NTW = T / 32;  // n-tiles of 8 columns per warp
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m = nt * T;
  const int8_t* st = tri + (size_t)idx[b] * (size_t)(2 * T) * (size_t)S;
  const __nv_bfloat16* u = U + (size_t)b * K * m;
  const int o_base = warp * NTW * 8;

  float acc[NTW][4];
#pragma unroll
  for (int nn = 0; nn < NTW; ++nn)
    acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.f;

  // forward: tile (j, c) applied to u's block c -> storage rows are outputs
  const int off_j = tile_offset(j, nt);
  for (int c = j; c < nt; ++c) {
    const long long col0 = (long long)(off_j + c - j) * T;
    for (int ks = 0; ks < T / 16; ++ks) {
      uint32_t a[4];
      load_a(a, u, K, m, g, tig, c * T + ks * 16);
#pragma unroll
      for (int nn = 0; nn < NTW; ++nn) {
        const int8_t* p = st + (size_t)(o_base + nn * 8 + g) * S + col0 +
                          ks * 16 + 2 * tig;
        const uint16_t lo = __ldg(reinterpret_cast<const unsigned short*>(p));
        const uint16_t hi =
            __ldg(reinterpret_cast<const unsigned short*>(p + 8));
        mma_bf16(acc[nn], a, i8pair(lo), i8pair(hi));
      }
    }
  }
  // transposed: strictly-upper tile (r, j) applied to u's block r
  for (int r = 0; r < j; ++r) {
    const long long col0 = (long long)(tile_offset(r, nt) + j - r) * T;
    for (int ks = 0; ks < T / 16; ++ks) {
      uint32_t a[4];
      load_a(a, u, K, m, g, tig, r * T + ks * 16);
#pragma unroll
      for (int nn = 0; nn < NTW; ++nn) {
        const int o = o_base + nn * 8;
        const int h = o / T;
        const int l = o % T + g;
        const int8_t* p =
            st + (size_t)(h * T + ks * 16 + 2 * tig) * S + col0 + l;
        const uint32_t b0 = pack_bf16((float)__ldg(p), (float)__ldg(p + S));
        const uint32_t b1 =
            pack_bf16((float)__ldg(p + 8 * S), (float)__ldg(p + 9 * S));
        mma_bf16(acc[nn], a, b0, b1);
      }
    }
  }

  const size_t row_stride = 2 * (size_t)m;
  float* ob = out + (size_t)b * K * row_stride;
#pragma unroll
  for (int nn = 0; nn < NTW; ++nn) {
    const int o = o_base + nn * 8 + 2 * tig;
    const int h = o / T;
    const size_t col = (size_t)h * m + (size_t)j * T + (o % T);
    if (g < K) {
      ob[(size_t)g * row_stride + col] = acc[nn][0] * scale;
      ob[(size_t)g * row_stride + col + 1] = acc[nn][1] * scale;
    }
    if (g + 8 < K) {
      ob[(size_t)(g + 8) * row_stride + col] = acc[nn][2] * scale;
      ob[(size_t)(g + 8) * row_stride + col + 1] = acc[nn][3] * scale;
    }
  }
}

// float / double storage: one thread per output column, K <= 16 sums in
// registers, the same fixed tile order.
template <typename F>
__global__ void __launch_bounds__(256) tri_matvec_float_kernel(
    const F* __restrict__ tri, const int* __restrict__ idx,
    const F* __restrict__ U, F* __restrict__ out, int K, int nt, int t,
    long long S) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int m = nt * t;
  const F* st = tri + (size_t)idx[b] * (size_t)(2 * t) * (size_t)S;
  const F* u = U + (size_t)b * K * m;
  const int off_j = tile_offset(j, nt);
  for (int o = threadIdx.x; o < 2 * t; o += blockDim.x) {
    const int h = o / t;
    const int l = o % t;
    F acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = F(0);
    for (int c = j; c < nt; ++c) {
      const F* row = st + (size_t)o * S + (size_t)(off_j + c - j) * t;
      for (int q = 0; q < t; ++q) {
        const F s = row[q];
        if (s == F(0)) continue;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < K) acc[k] += s * u[(size_t)k * m + c * t + q];
      }
    }
    for (int r = 0; r < j; ++r) {
      const F* colp = st + (size_t)(h * t) * S +
                      (size_t)(tile_offset(r, nt) + j - r) * t + l;
      for (int i = 0; i < t; ++i) {
        const F s = colp[(size_t)i * S];
        if (s == F(0)) continue;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < K) acc[k] += s * u[(size_t)k * m + r * t + i];
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < K)
        out[((size_t)b * K + k) * 2 * m + (size_t)h * m + (size_t)j * t + l] =
            acc[k];
  }
}

}  // namespace

extern "C" {

// tri (P, 2t, S) int8, idx (B,) int32, U (B, K, m) bf16, out (B, K, 2m) f32.
int tri_matvec_int8(const void* tri, const void* idx, const void* U, void* out,
                    int B, int K, int nt, int t, long long S, float scale,
                    void* stream) {
  if (K < 1 || K > 16) return (int)cudaErrorInvalidValue;
  const dim3 grid(nt, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (t == 256) {
    tri_matvec_int8_kernel<256><<<grid, 256, 0, st>>>(
        (const int8_t*)tri, (const int*)idx, (const __nv_bfloat16*)U,
        (float*)out, K, nt, S, scale);
  } else if (t == 128) {
    tri_matvec_int8_kernel<128><<<grid, 256, 0, st>>>(
        (const int8_t*)tri, (const int*)idx, (const __nv_bfloat16*)U,
        (float*)out, K, nt, S, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int tri_matvec_f32(const void* tri, const void* idx, const void* U, void* out,
                   int B, int K, int nt, int t, long long S, void* stream) {
  if (K < 1 || K > 16) return (int)cudaErrorInvalidValue;
  tri_matvec_float_kernel<float><<<dim3(nt, B), 256, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const int*)idx, (const float*)U, (float*)out, K, nt,
      t, S);
  return (int)cudaGetLastError();
}

int tri_matvec_f64(const void* tri, const void* idx, const void* U, void* out,
                   int B, int K, int nt, int t, long long S, void* stream) {
  if (K < 1 || K > 16) return (int)cudaErrorInvalidValue;
  tri_matvec_float_kernel<double>
      <<<dim3(nt, B), 256, 0, (cudaStream_t)stream>>>(
          (const double*)tri, (const int*)idx, (const double*)U,
          (double*)out, K, nt, t, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
