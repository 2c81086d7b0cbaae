// Single-problem dual matvec over the symmetric-triangle tile list, for
// Hopper.
//
// Replaces the TPU kernel
// clipper_tpu/ops/symstore.py:make_sym_dual_matvec_pallas (Pallas body
// :360-390, launch :398-417), and serves the function the XLA tile matvec
// computes with explicit coordinates (symstore.py:226-311): the
// single-device tile-list solve and each rank's slice in the
// triangle-sharded engine.
//
// What it computes. Storage is (T, 2t, t): tile k holds block (rows[k],
// cols[k]) of the upper triangle, rows 0:t M's tile and rows t:2t C's; an
// inert slot (nt, nt) is a zero tile. Given the K candidate rows U (K, m),
// the kernel writes out = [M U'; C U']' as (K, 2m): for every stored tile
// k = (r, c), the forward product tile_k @ u[c] into block r, and for
// r != c the transposed product tile_k' @ u[r] into block c (a diagonal tile
// already holds its full symmetric content, symstore.py:231-233, 290-300).
//
// Design. One block per (output block j, group of at most 16 candidate
// rows), which owns its outputs outright: no atomics, and a rerun is bit
// identical. The host builds, once per storage (ops/symstore.tile_walks),
// each output block's walk: the forward tiles of row j, then the
// transposed tiles of column j, each in increasing k, as (k, 2 ub + tr)
// pairs with ub the block of u the tile contracts; inert slots are in no
// walk and never index u. The block streams its walk's tiles through a
// double-buffered shared-memory stage and applies them exactly as the rows
// kernel does (csrc/sym_tile_mma.cuh): int8 and bf16 at t = 128 on the
// tensor cores (mma.sync.m16n8k16 bf16, the bias trick for the int8
// codes), f32 and f64 on CUDA cores. Tile partials are summed in f64 and
// rounded once to f32 (raw = 0), or written unrounded in f64 (raw = 1) for the sharded engine,
// which sums the ranks' slices before that one rounding.
//
// What bounds it on this card. At m = 65,536 (t = 128, K = 16) the tile
// list is 131,328 x 32 KB = 4.30 GB: read once, 1.285 ms at 3.35 TB/s; the
// products are 4 m^2 K = 2.7e11 bf16 flops, 0.28 ms at 989 TFLOP/s. It is
// bound by bytes. This design reads each off-diagonal tile twice (by block
// r forward and block c transposed), 8.59 GB a call, so expect about 2x the
// bound; a one-read design that stays deterministic, and TMA / wgmma
// staging, are later work. Tile offsets are 64-bit: T * 2t * t passes 2^31.

#include "sym_tile_mma.cuh"

namespace {

using namespace symtile;

// S: int8 codes or bf16, on the tensor cores
template <typename S>
__global__ void __launch_bounds__(kThreads, 2) sym_tiles_mma_kernel(
    const S* __restrict__ tiles, const int2* __restrict__ walks,
    const int* __restrict__ offsets, const __nv_bfloat16* __restrict__ U,
    void* __restrict__ out, int K, int nt, int raw, float scale) {
  extern __shared__ __align__(16) int8_t smem[];
  const int j = blockIdx.x;
  const int k0 = blockIdx.y * kMaxK;
  const int Kb = min(kMaxK, K - k0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int m = nt * kT;
  const int o_base = warp * kNtw * 8;
  const size_t tile_elems = 2 * (size_t)kT * kT;
  const __nv_bfloat16* Ub = U + (size_t)k0 * m;
  void* outb = raw ? (void*)((double*)out + (size_t)k0 * 2 * m)
                   : (void*)((float*)out + (size_t)k0 * 2 * m);
  const int e0 = offsets[j];
  const int total = offsets[j + 1] - e0;

  double acc[kNtw][4];
#pragma unroll
  for (int nn = 0; nn < kNtw; ++nn)
    acc[nn][0] = acc[nn][1] = acc[nn][2] = acc[nn][3] = 0.0;

  // cp.async group g carries walk entry g (groups past the end are empty)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total)
      stage_tile(smem + s * TileStage<S>::kBytes,
                 tiles + (size_t)walks[e0 + s].x * tile_elems, kT);
    cp_async_commit();
  }

  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();      // tile it has landed
    __syncthreads();                   // ... for every thread, and tile
                                       // it - 1's buffer is free again
    const int next = it + kStages - 1;
    if (next < total)
      stage_tile(smem + (next % kStages) * TileStage<S>::kBytes,
                 tiles + (size_t)walks[e0 + next].x * tile_elems, kT);
    cp_async_commit();
    const int code = walks[e0 + it].y;
    float part[kNtw][4];
    apply_tile<S>(part, smem + (it % kStages) * TileStage<S>::kBytes, Ub,
                  Kb, m, g, tig, o_base, (code & 1) == 0, code >> 1);
#pragma unroll
    for (int nn = 0; nn < kNtw; ++nn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[nn][q] += (double)part[nn][q];
  }
  store_mma(acc, outb, raw, scale, Kb, m, j, g, tig, o_base);
}

// float / double tiles: one thread per output column, the same walk.
template <typename F>
__global__ void __launch_bounds__(kThreads) sym_tiles_float_kernel(
    const F* __restrict__ tiles, const int2* __restrict__ walks,
    const int* __restrict__ offsets, const F* __restrict__ U,
    void* __restrict__ out, int K, int nt, int t, int raw) {
  const int j = blockIdx.x;
  const int k0 = blockIdx.y * kMaxK;
  const int Kb = min(kMaxK, K - k0);
  const int m = nt * t;
  const size_t tile_elems = 2 * (size_t)t * t;
  const F* Ub = U + (size_t)k0 * m;
  void* outb = raw ? (void*)((double*)out + (size_t)k0 * 2 * m)
                   : (void*)((float*)out + (size_t)k0 * 2 * m);
  const int e0 = offsets[j];
  const int e1 = offsets[j + 1];
  for (int o = threadIdx.x; o < 2 * t; o += blockDim.x) {
    double acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.0;
    for (int e = e0; e < e1; ++e) {
      const int2 w = walks[e];
      apply_tile_float(acc, tiles + (size_t)w.x * tile_elems, (size_t)t, Ub,
                       Kb, m, t, o, (w.y & 1) == 0, w.y >> 1);
    }
    store_float(acc, outb, raw, Kb, m, t, j, o);
  }
}

dim3 grid_of(int nt, int K) { return dim3(nt, (K + kMaxK - 1) / kMaxK); }

template <typename S>
int launch_mma(const void* tiles, const void* walks, const void* offsets,
               const void* U, void* out, int K, int nt, int t, int raw,
               float scale, void* stream) {
  if (K < 1 || nt < 1 || t != kT) return (int)cudaErrorInvalidValue;
  const int smem_bytes = kStages * TileStage<S>::kBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      sym_tiles_mma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  sym_tiles_mma_kernel<S><<<grid_of(nt, K), kThreads, smem_bytes,
                            (cudaStream_t)stream>>>(
      (const S*)tiles, (const int2*)walks, (const int*)offsets,
      (const __nv_bfloat16*)U, out, K, nt, raw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tiles (T, 2t, t) int8 codes in 0..127; walks (E, 2) and offsets (nt + 1,)
// int32 from tile_walks; U (K, m) bf16; out (K, 2m) f32 (raw = 0) or f64
// (raw = 1); t must be 128.
int sym_tiles_matvec_int8(const void* tiles, const void* walks,
                          const void* offsets, const void* U, void* out, int K,
                          int nt, int t, int raw, float scale, void* stream) {
  return launch_mma<int8_t>(tiles, walks, offsets, U, out, K, nt, t, raw,
                            scale, stream);
}

// the same over bf16 tiles (no scale)
int sym_tiles_matvec_bf16(const void* tiles, const void* walks,
                          const void* offsets, const void* U, void* out, int K,
                          int nt, int t, int raw, void* stream) {
  return launch_mma<__nv_bfloat16>(tiles, walks, offsets, U, out, K, nt, t,
                                   raw, 1.f, stream);
}

// tiles f32, U (K, m) f32, out as above.
int sym_tiles_matvec_f32(const void* tiles, const void* walks,
                         const void* offsets, const void* U, void* out, int K,
                         int nt, int t, int raw, void* stream) {
  if (K < 1 || nt < 1 || t < 1) return (int)cudaErrorInvalidValue;
  sym_tiles_float_kernel<float><<<grid_of(nt, K), kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const float*)tiles, (const int2*)walks, (const int*)offsets,
      (const float*)U, out, K, nt, t, raw);
  return (int)cudaGetLastError();
}

// tiles f64, U (K, m) f64, out as above.
int sym_tiles_matvec_f64(const void* tiles, const void* walks,
                         const void* offsets, const void* U, void* out, int K,
                         int nt, int t, int raw, void* stream) {
  if (K < 1 || nt < 1 || t < 1) return (int)cudaErrorInvalidValue;
  sym_tiles_float_kernel<double><<<grid_of(nt, K), kThreads, 0,
                                   (cudaStream_t)stream>>>(
      (const double*)tiles, (const int2*)walks, (const int*)offsets,
      (const double*)U, out, K, nt, t, raw);
  return (int)cudaGetLastError();
}

}  // extern "C"
