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
// products of the strictly-upper tiles (r < j, j). Numerics as the JAX
// kernel's: int8 codes 0..127 become bf16 exactly, storage and u are bf16,
// products accumulate in f32, and the 1/127 scale is applied at the end.
//
// What bounds it on this card. Each tick reads every lane's whole triangle
// once (B * 2t * S bytes for int8: 168 MB at B=128, m=1024) against 2 K
// flops per stored element and direction: ~45 flops/byte at K=16, far below
// the ~295 flops/byte where the bf16 tensor cores would bind. It is bound by
// bytes, so the design reads every stored byte from HBM once.
//
// Design: one read of each tile. M u and C u are independent, so one
// block per (half h, lane b) owns that half's whole output row (K, m) and
// reads only its half's rows of the lane's tiles: tile (r, c)'s t rows of
// half h leave HBM once, in panels of 64 rows. No block needs another's
// data, so there is no cluster, and nt (1 to 16 in the pool) is bounded
// only by the output row. A producer warp copies each panel into a ring of
// shared-memory stages with 2-D tensor-map copies (cp.async.bulk.tensor
// over the (P 2t, S) view of the storage, the row taken from idx[b]; the
// TMA engine), one (64 rows, 128 bytes) box a copy, that complete on the
// stage's "full" mbarrier (one bulk copy a row, 256 bytes at int8, left
// the copies alone well under the memory rate). Eight consumer warps wait
// on it, take BOTH products from the staged copy, and release the stage on
// its "empty" mbarrier, which the producer waits on before refilling it.
// Fragments come from the stage by ldmatrix (forward: the tile's rows are
// outputs) and ldmatrix.trans (transposed: its columns are outputs). The
// candidates' blocks of each tile (u_c for the forward product, u_r for
// the transposed one) are bulk-copied into one of two u slots with
// barriers of their own, so both mma operands come from shared memory
// (read through L1 instead, each u fragment load touches 8 rows of u, and
// at K=16 those loads, not bytes, held the kernel back). The storage tile
// is the m16 operand of mma.sync.m16n8k16 and the K candidates the n8
// operand, so one n8 serves K <= 8 (the K=1 init calls waste 7 of 8
// columns, not 15 of 16 rows). int8 codes become bf16 by the bias trick
// (bf16_mma.cuh); bf16 storage is used as it is.
//
// The kernel is tri_matvec_mma.cuh's, with the flat address map
// (FlatTiles); tri_tiles_matvec.cu runs the same kernel over tile-major
// storage. The panel products (forward and transposed, int8 and bf16
// fragments) are bf16_mma.cuh's, shared with the capacity engines'
// kernels; the copies, barriers and the tensor map are hopper_copy.cuh's.
// The copies swizzle each 128-byte row segment's 16-byte chunks by the
// row, so the 8 rows of an ldmatrix hit distinct banks, except the
// forward's even rows at int8, which meet in pairs (a 2-way conflict).
//
// Determinism. A block walks its tiles in storage order (r = 0..nt-1,
// c = r..nt-1) and owns its outputs outright: no atomics. Forward products
// of row r accumulate in registers; block c's raw sums live in the output
// buffer between tiles: before tile (r, c) the thread that owns them loads
// them (0 at r = 0; loaded ahead, so the latency hides behind the tile),
// adds the tile's transposed panel products in order and stores them back,
// all in program order. When row r ends, block r's outputs are final:
// (transposed sums r' = 0..r-1 + forward sum) * scale. Every output is
// summed in one fixed order, so a rerun reproduces every lane bit for bit.
// The output buffer's read-backs stay in L2 (B * K * 2m * 4 bytes: 17 MB at
// B=128, K=16, m=1024); HBM sees each stored byte once.
//
// The float / double storage kinds take a plain CUDA-core kernel that
// accumulates in the storage type (f64 in f64, as the JAX package does).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_matvec_mma.cuh"

namespace {

__device__ __forceinline__ int tile_offset(int r, int nt) {
  return r * nt - r * (r - 1) / 2;
}

template <typename S>
int dispatch_mma(const void* tri, const void* idx, const void* U, void* out,
                 int P, int B, int K, int nt, int t, long long S_cols,
                 float scale, void* stream) {
  if (K < 1 || K > 16 || B < 1 || B > 65535 || nt < 1 || P < 1 ||
      (t != 128 && t != 256))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t err =
      storage_map<S>(&map, tri, (long long)P * 2 * t, S_cols, kPanel);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (t == 256)
    return K <= 8 ? launch_mma<S, 256, 1, FlatTiles>(map, idx, U, out, B, K,
                                                     nt, scale, st)
                  : launch_mma<S, 256, 2, FlatTiles>(map, idx, U, out, B, K,
                                                     nt, scale, st);
  return K <= 8 ? launch_mma<S, 128, 1, FlatTiles>(map, idx, U, out, B, K,
                                                   nt, scale, st)
                : launch_mma<S, 128, 2, FlatTiles>(map, idx, U, out, B, K, nt,
                                                   scale, st);
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

// tri (P, 2t, S) int8 codes in 0..127, idx (B,) int32, U (B, K, m) bf16,
// out (B, K, 2m) f32; t in (128, 256), K <= 16; tri 16-byte aligned.
int tri_matvec_int8(const void* tri, const void* idx, const void* U, void* out,
                    int P, int B, int K, int nt, int t, long long S,
                    float scale, void* stream) {
  return dispatch_mma<int8_t>(tri, idx, U, out, P, B, K, nt, t, S, scale,
                              stream);
}

// tri (P, 2t, S) bf16, the rest as tri_matvec_int8 (no scale).
int tri_matvec_bf16(const void* tri, const void* idx, const void* U, void* out,
                    int P, int B, int K, int nt, int t, long long S,
                    void* stream) {
  return dispatch_mma<__nv_bfloat16>(tri, idx, U, out, P, B, K, nt, t, S,
                                     1.f, stream);
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
