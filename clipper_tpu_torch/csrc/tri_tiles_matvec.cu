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
// and no assembly matrix exists:
//   block j = forward products of tiles (j, c), c = j..nt-1, in order,
//           then transposed products of tiles (r, j), r = 0..j-1, in order
// (diagonal tiles only forward: their content is complete there). No
// atomics, so a rerun reproduces every lane bit for bit.
//
// Numerics as the JAX kernel's: int8 codes times bf16-rounded u (exact
// products in f32), summed in f32 and scaled by 1/127 once; bf16 storage
// times bf16 u, summed in f32; f32 storage in f32; f64 storage in f64.
//
// What bounds it on this card: every lane's whole storage read once a
// call (B * T * 2t * t bytes for int8: 168 MB at B=128, m=1024, t=256,
// 0.05 ms at 3.35 TB/s) against 2 flops a stored byte and direction:
// bytes. Unlike tri_matvec.cu's strided row segments, a tile is one
// contiguous block. Design, simple and on CUDA cores: one block of 8 warps
// per (output block j, lane b). A forward tile's 2t rows go to the warps,
// each row read by one warp as t contiguous elements (t / 32 a lane,
// vector loads) and reduced by a fixed shuffle tree; a transposed tile is
// read row by row, each thread holding 4 adjacent columns of one group of
// rows, and the row groups' partial sums are added in a fixed order
// through shared memory. The u block a tile needs is staged in shared
// memory first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename S, int V>
struct alignas(sizeof(S) * V) Pack {
  S v[V];
};

__device__ __forceinline__ float widen(int8_t x) { return (float)x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ double widen(double x) { return x; }

__device__ __forceinline__ float load_u(const __nv_bfloat16* u, int i) {
  return __bfloat162float(u[i]);
}
__device__ __forceinline__ float load_u(const float* u, int i) { return u[i]; }
__device__ __forceinline__ double load_u(const double* u, int i) {
  return u[i];
}

__device__ __forceinline__ float shfl_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double shfl_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// S: storage element; U: the operand's type; A: accumulator; TT: tile t.
template <typename S, typename U, typename A, int TT>
__global__ void __launch_bounds__(kThreads) tri_tiles_matvec_kernel(
    const S* __restrict__ tri, const int* __restrict__ idx,
    const U* __restrict__ Uin, A* __restrict__ out, int nt, int T, A scale) {
  constexpr int V = TT / 32;        // forward: elements a lane
  constexpr int NCG = TT / 4;       // transposed: column groups of 4
  constexpr int G = kThreads / NCG;  // transposed: row groups
  __shared__ A ub[TT];
  __shared__ A y[2 * TT];
  __shared__ A part[G][2 * TT];

  const int j = blockIdx.x;  // output block
  const int b = blockIdx.y;  // lane
  const int m = nt * TT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const S* lane_tri = tri + (size_t)idx[b] * T * (2 * TT) * TT;
  const U* u = Uin + (size_t)b * m;

  for (int o = tid; o < 2 * TT; o += kThreads) y[o] = (A)0;

  // forward: tiles (j, c), c = j..nt-1, at k = off_j + c - j
  const int off_j = j * nt - j * (j - 1) / 2;
  for (int c = j; c < nt; ++c) {
    __syncthreads();
    for (int q = tid; q < TT; q += kThreads) ub[q] = (A)load_u(u, c * TT + q);
    __syncthreads();
    const S* tile = lane_tri + (size_t)(off_j + c - j) * (2 * TT) * TT;
    for (int i = warp; i < 2 * TT; i += kWarps) {
      const Pack<S, V> p =
          *reinterpret_cast<const Pack<S, V>*>(tile + (size_t)i * TT + lane * V);
      A s = (A)0;
#pragma unroll
      for (int e = 0; e < V; ++e) s += (A)widen(p.v[e]) * ub[lane * V + e];
      s = shfl_sum(s);
      if (lane == 0) y[i] += s;
    }
  }

  // transposed: tiles (r, j), r = 0..j-1, at k = off_r + j - r
  const int cg = tid % NCG, g = tid / NCG;
  for (int r = 0; r < j; ++r) {
    __syncthreads();
    for (int q = tid; q < TT; q += kThreads) ub[q] = (A)load_u(u, r * TT + q);
    __syncthreads();
    const int off_r = r * nt - r * (r - 1) / 2;
    const S* tile = lane_tri + (size_t)(off_r + j - r) * (2 * TT) * TT;
    A am[4] = {(A)0, (A)0, (A)0, (A)0};
    A ac[4] = {(A)0, (A)0, (A)0, (A)0};
    for (int s = g; s < TT; s += G) {
      const Pack<S, 4> pm = *reinterpret_cast<const Pack<S, 4>*>(
          tile + (size_t)s * TT + cg * 4);
      const Pack<S, 4> pc = *reinterpret_cast<const Pack<S, 4>*>(
          tile + (size_t)(TT + s) * TT + cg * 4);
      const A us = ub[s];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        am[e] += (A)widen(pm.v[e]) * us;
        ac[e] += (A)widen(pc.v[e]) * us;
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
    ob[j * TT + o] = y[o] * scale;
    ob[m + j * TT + o] = y[TT + o] * scale;
  }
}

template <typename S, typename U, typename A>
int launch(const void* tri, const void* idx, const void* Uin, void* out,
           int B, int nt, int t, A scale, void* stream) {
  if (B < 1 || B > 65535 || nt < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(nt, B);
  const int T = nt * (nt + 1) / 2;
  cudaStream_t st = (cudaStream_t)stream;
  if (t == 256) {
    tri_tiles_matvec_kernel<S, U, A, 256><<<grid, kThreads, 0, st>>>(
        (const S*)tri, (const int*)idx, (const U*)Uin, (A*)out, nt, T, scale);
  } else if (t == 128) {
    tri_tiles_matvec_kernel<S, U, A, 128><<<grid, kThreads, 0, st>>>(
        (const S*)tri, (const int*)idx, (const U*)Uin, (A*)out, nt, T, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tri (P, T, 2t, t) int8, idx (B,) int32, U (B, m) bf16, out (B, 2m) f32.
int tri_tiles_matvec_int8(const void* tri, const void* idx, const void* U,
                          void* out, int B, int nt, int t, float scale,
                          void* stream) {
  return launch<int8_t, __nv_bfloat16, float>(tri, idx, U, out, B, nt, t,
                                              scale, stream);
}

// bf16 storage: U (B, m) bf16, out (B, 2m) f32 (exact products, f32 sums).
int tri_tiles_matvec_bf16(const void* tri, const void* idx, const void* U,
                          void* out, int B, int nt, int t, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, float>(tri, idx, U, out, B, nt,
                                                     t, 1.f, stream);
}

// f32 storage: U (B, m) f32, out (B, 2m) f32.
int tri_tiles_matvec_f32(const void* tri, const void* idx, const void* U,
                         void* out, int B, int nt, int t, void* stream) {
  return launch<float, float, float>(tri, idx, U, out, B, nt, t, 1.f,
                                     stream);
}

// f64 storage: U (B, m) f64, out (B, 2m) f64.
int tri_tiles_matvec_f64(const void* tri, const void* idx, const void* U,
                         void* out, int B, int nt, int t, void* stream) {
  return launch<double, double, double>(tri, idx, U, out, B, nt, t, 1.0,
                                        stream);
}

}  // extern "C"
