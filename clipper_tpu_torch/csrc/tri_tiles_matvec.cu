// Batched single-probe dual matvec over tile-major triangle pool storage,
// for Hopper.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:
// make_tri_pool_matvec_tiles (:283-386). Storage is (P, T, 2t, t) with
// T = nt (nt + 1) / 2: tile k (row block r_k, column block c_k, in
// flattri.tri_coords order) is the contiguous (2t, t) block [M_rc; C_rc].
// Lane b reads problem idx[b] and its row U[b] (m,), and writes
// out[b] = [M u; C u] (2m,). The TPU kernel ran three tile-batched
// contractions a lane (forward tiles, transposed M and C halves) and left
// the assembly of the per-tile products into output blocks to XLA's
// einsums; here each output block sums its own products in a fixed order
// and no assembly matrix exists. No atomics, so a rerun reproduces every
// lane bit for bit.
//
// Numerics as the JAX kernel's: int8 codes times bf16-rounded u (exact
// products in f32), summed in f32 and scaled by 1/127 once; bf16 storage
// times bf16 u, summed in f32; f32 storage in f32; f64 storage in f64.
//
// What bounds it on this card: every lane's whole storage read once a
// call (B * T * 2t * t bytes for int8: 168 MB at B=128, m=1024, t=256,
// 0.05 ms at 3.35 TB/s) against 2 flops a stored byte and direction:
// bytes.
//
// Design for int8 and bf16 storage (the pool's): kernel 1's, over another
// address map. The tile-major layout holds the flat layout's tiles in the
// same order, each made contiguous, so this file runs tri_matvec_mma.cuh's
// kernel (one block per (half, lane), each tile's half read once from HBM
// in 64-row panels through a ring of tensor-map copies, both products by
// mma.sync, outputs owned with no atomics) with the TileMajor policy: the
// tensor map views the storage as (P T 2t, t) rows, and tile k's half h
// starts at row ((idx[b] T + k) 2 + h) t. At one probe the kernel runs the
// instructions of kernel 1 at K=1 in the same order, so on the same
// content the two give the same bits. The one probe uses one of the
// mma's 8 n8 columns (kernel 1's K=1 cost too); the kernel stays bound by
// bytes.
//
// Routes by tile (the dispatch below, which reports the route it took
// through `route`; the wrapper counts each route's launches under its own
// key, and ops/flattri.matvec_route mirrors the rule):
//   "mma"   int8 / bf16 at t = 128, 256, 384, 512: kernel 1's tensor-core
//           kernel (TileMajor), above;
//   "super" int8 / bf16 at every other multiple of 16: kernel 1's
//           super-tile kernel (TileSuper: each 128-row super-tile's panel
//           from (kG rows, kG elements) boxes of its sub-tiles, kG the
//           largest of 64, 32, 16 dividing t);
//   "core"  int8 / bf16 at every other t <= 7680 dividing m:
//           tri_matvec_core.cuh's CUDA-core kernel (TileMajor), kernel 1's
//           route for those.
// The f32 / f64 storage kinds (not on the pool's hot path), counted under
// the kernel's own key at every t, take by t alone:
//   t = 128, 256: a warp-row CUDA-core kernel: one block of 8 warps per
//     (output block j, lane b). A forward tile's 2t rows go to the warps,
//     each row read by one warp as t contiguous elements (t / 32 a lane,
//     vector loads) and reduced by a fixed shuffle tree; a transposed tile
//     is read row by row, each thread holding 4 adjacent columns of one
//     group of rows, and the row groups' partial sums are added in a
//     fixed order through shared memory:
//       block j = forward products of tiles (j, c), c = j..nt-1, in order,
//           then transposed products of tiles (r, j), r = 0..j-1, in order
//     (diagonal tiles only forward: their content is complete there).
//   every other t <= 7680: tri_matvec_core.cuh's CUDA-core kernel
//     (TileMajor), kernel 1's float kernel.
// Their times on an H100 are in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tri_matvec_core.cuh"
#include "tri_matvec_mma.cuh"

namespace {

// int8 / bf16 storage: kernel 1's super-tile kernel over sub-tile boxes
// (route "super"), the CUDA-core kernel (route "core"), or the tensor map
// over the (P T 2t, t) view and kernel 1's kernel at one n8 group (route
// "mma")
template <typename S>
int dispatch(const void* tri, const void* idx, const void* U, void* out,
             int P, int B, int nt, int t, float scale, void* stream,
             int* route) {
  if (B < 1 || B > 65535 || nt < 1 || P < 1 || t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)P * (nt * (nt + 1) / 2) * 2 * t;
  if (super_tile(t)) {  // route "super"
    *route = kRouteSuper;
    return launch_super<S, true>(tri, rows, t, idx, U, out, B, 1, nt, t,
                                 scale, st);
  }
  if (!mma_tile(t)) {  // route "core"
    *route = kRouteCore;
    return core::launch_core<S>(tri, idx, U, out, B, 1, nt,
                                core::TileMajor{t}, scale, st);
  }
  *route = kRouteMma;  // route "mma": the copies' row coordinate is 32-bit
  if (rows > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t err = storage_map<S>(&map, tri, rows, t, kPanel);
  if (err != cudaSuccess) return (int)err;
  switch (t) {
    case 128:
      return launch_mma<S, 128, 1, TileMajor>(map, idx, U, out, B, 1, nt,
                                              scale, st);
    case 256:
      return launch_mma<S, 256, 1, TileMajor>(map, idx, U, out, B, 1, nt,
                                              scale, st);
    case 384:
      return launch_mma<S, 384, 1, TileMajor>(map, idx, U, out, B, 1, nt,
                                              scale, st);
    default:
      return launch_mma<S, 512, 1, TileMajor>(map, idx, U, out, B, 1, nt,
                                              scale, st);
  }
}

template <typename S, int V>
struct alignas(sizeof(S) * V) Pack {
  S v[V];
};

template <typename A>
__device__ __forceinline__ A shfl_sum(A v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A: the storage, operand and accumulator type (float or double); TT: t.
template <typename A, int TT>
__global__ void __launch_bounds__(256) tri_tiles_float_kernel(
    const A* __restrict__ tri, const int* __restrict__ idx,
    const A* __restrict__ Uin, A* __restrict__ out, int nt, int T) {
  constexpr int kThreads = 256;
  constexpr int kWarps = kThreads / 32;
  constexpr int V = TT / 32;         // forward: elements a lane
  constexpr int NCG = TT / 4;        // transposed: column groups of 4
  constexpr int G = kThreads / NCG;  // transposed: row groups
  __shared__ A ub[TT];
  __shared__ A y[2 * TT];
  __shared__ A part[G][2 * TT];

  const int j = blockIdx.x;  // output block
  const int b = blockIdx.y;  // lane
  const int m = nt * TT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const A* lane_tri = tri + (size_t)idx[b] * T * (2 * TT) * TT;
  const A* u = Uin + (size_t)b * m;

  for (int o = tid; o < 2 * TT; o += kThreads) y[o] = (A)0;

  // forward: tiles (j, c), c = j..nt-1, at k = off_j + c - j
  const int off_j = j * nt - j * (j - 1) / 2;
  for (int c = j; c < nt; ++c) {
    __syncthreads();
    for (int q = tid; q < TT; q += kThreads) ub[q] = u[c * TT + q];
    __syncthreads();
    const A* tile = lane_tri + (size_t)(off_j + c - j) * (2 * TT) * TT;
    for (int i = warp; i < 2 * TT; i += kWarps) {
      const Pack<A, V> p = *reinterpret_cast<const Pack<A, V>*>(
          tile + (size_t)i * TT + lane * V);
      A s = (A)0;
#pragma unroll
      for (int e = 0; e < V; ++e) s += p.v[e] * ub[lane * V + e];
      s = shfl_sum(s);
      if (lane == 0) y[i] += s;
    }
  }

  // transposed: tiles (r, j), r = 0..j-1, at k = off_r + j - r
  const int cg = tid % NCG, g = tid / NCG;
  for (int r = 0; r < j; ++r) {
    __syncthreads();
    for (int q = tid; q < TT; q += kThreads) ub[q] = u[r * TT + q];
    __syncthreads();
    const int off_r = r * nt - r * (r - 1) / 2;
    const A* tile = lane_tri + (size_t)(off_r + j - r) * (2 * TT) * TT;
    A am[4] = {(A)0, (A)0, (A)0, (A)0};
    A ac[4] = {(A)0, (A)0, (A)0, (A)0};
    for (int s = g; s < TT; s += G) {
      const Pack<A, 4> pm = *reinterpret_cast<const Pack<A, 4>*>(
          tile + (size_t)s * TT + cg * 4);
      const Pack<A, 4> pc = *reinterpret_cast<const Pack<A, 4>*>(
          tile + (size_t)(TT + s) * TT + cg * 4);
      const A us = ub[s];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        am[e] += pm.v[e] * us;
        ac[e] += pc.v[e] * us;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      part[g][cg * 4 + e] = am[e];
      part[g][TT + cg * 4 + e] = ac[e];
    }
    __syncthreads();
    for (int o = tid; o < 2 * TT; o += kThreads) {
      A v = part[0][o];
#pragma unroll
      for (int q = 1; q < G; ++q) v += part[q][o];
      y[o] += v;
    }
  }
  __syncthreads();

  A* ob = out + (size_t)b * 2 * m;
  for (int o = tid; o < TT; o += kThreads) {
    ob[j * TT + o] = y[o];
    ob[m + j * TT + o] = y[TT + o];
  }
}

// f32 / f64 storage: the warp-row kernel at t = 128 and 256, the
// CUDA-core kernel at every other t
template <typename A>
int launch_float(const void* tri, const void* idx, const void* Uin, void* out,
                 int B, int nt, int t, void* stream) {
  if (B < 1 || B > 65535 || nt < 1 || t < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nt, B);
  const int T = nt * (nt + 1) / 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (t == 256) {
    tri_tiles_float_kernel<A, 256><<<grid, 256, 0, st>>>(
        (const A*)tri, (const int*)idx, (const A*)Uin, (A*)out, nt, T);
  } else if (t == 128) {
    tri_tiles_float_kernel<A, 128><<<grid, 256, 0, st>>>(
        (const A*)tri, (const int*)idx, (const A*)Uin, (A*)out, nt, T);
  } else {
    return core::launch_core<A>(tri, idx, Uin, out, B, 1, nt,
                                core::TileMajor{t}, 1.f, st);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tri (P, T, 2t, t) int8 codes in 0..127, idx (B,) int32, U (B, m) bf16,
// out (B, 2m) f32; any t >= 1 (t <= 7680 off the tensor cores); tri
// 16-byte aligned (routes "mma" and "super": the tensor map's base);
// *route set to the route taken (kRouteMma, kRouteSuper, kRouteCore).
int tri_tiles_matvec_int8(const void* tri, const void* idx, const void* U,
                          void* out, int P, int B, int nt, int t, float scale,
                          void* stream, int* route) {
  return dispatch<int8_t>(tri, idx, U, out, P, B, nt, t, scale, stream,
                          route);
}

// bf16 storage, the rest as tri_tiles_matvec_int8 (no scale).
int tri_tiles_matvec_bf16(const void* tri, const void* idx, const void* U,
                          void* out, int P, int B, int nt, int t,
                          void* stream, int* route) {
  return dispatch<__nv_bfloat16>(tri, idx, U, out, P, B, nt, t, 1.f,
                                 stream, route);
}

// f32 storage: U (B, m) f32, out (B, 2m) f32; tri 64-byte aligned (the
// warp-row kernel's vector loads).
int tri_tiles_matvec_f32(const void* tri, const void* idx, const void* U,
                         void* out, int B, int nt, int t, void* stream) {
  return launch_float<float>(tri, idx, U, out, B, nt, t, stream);
}

// f64 storage: U (B, m) f64, out (B, 2m) f64; tri 64-byte aligned.
int tri_tiles_matvec_f64(const void* tri, const void* idx, const void* U,
                         void* out, int B, int nt, int t, void* stream) {
  return launch_float<double>(tri, idx, U, out, B, nt, t, stream);
}

}  // extern "C"
