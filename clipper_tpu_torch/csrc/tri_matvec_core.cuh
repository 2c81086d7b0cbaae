// The CUDA-core route of kernels 1 and 9 (tri_matvec.cu, flat storage, K
// candidates a lane; tri_tiles_matvec.cu, tile-major storage, one probe a
// lane): int8 / bf16 at the tiles their tensor-core kernel does not take
// (t not a multiple of 128, or past 512, where tri_matvec_mma.cuh's
// 64-row panels, 128-byte boxes and eight 16-row output blocks a warp do
// not tile the (2t, t) tile or its ring does not fit), and the f32 / f64
// storage kinds (kernel 1's at every t, kernel 9's but at t = 128 and 256,
// where its warp-row kernel is faster). It takes every t >= 1 that divides
// m, for every storage kind: int8 codes and bf16 (u rounded to bf16,
// products exact in f32, summed in f32, the 1/127 scale at the end, as the
// JAX kernel), f32 (f32 sums) and f64 (f64 sums).
//
// What bounds it on this card. It reads each stored element twice, once
// in the forward product of its row block and once in the transposed
// product of its column block (the second read mostly from L2), and does
// 2 K multiply-adds an element on CUDA cores: at K = 16 the products, not
// the bytes, bound it (67 TFLOP/s of f32 against the tensor cores' 989);
// it is the route of the tiles that no tensor-core tiling takes, kept
// simple and right, and its times are in PERF.md.
//
// Design: one block per (output block j, lane b) and group of up to 256
// outputs (half h, position l) of the block, one output a thread, K <= 16
// sums in registers. The block walks the forward tiles (j, c), c =
// j..nt-1, then the transposed tiles (r, j), r = 0..j-1; each thread
// reads its stored row of a forward tile and its stored column of a
// transposed one (consecutive threads on consecutive columns). The
// candidates' values of the tile's positions are staged in shared memory
// 128 positions at a time, as [position][candidate] rows of 16, so a
// thread reads a position's K values as 16-byte broadcasts (every thread
// of the block is at the same position), not K loads from L1. Zero
// elements are skipped. Every output is summed in one fixed order, with
// no atomics (a rerun is bit-identical): products in runs of 16 from zero
// (from the tile's first position), each run summed in the accumulator
// type A (exact products in f32 for codes, so a run errs by about an ulp
// of its 16 terms), the runs added in f64 and the total rounded once to
// A. (A running f32 sum of the runs sat 9.3e-6 from an f64 oracle at m =
// 2048, against a bar of 1.1e-5.) Kernels 1 and 9 run the same
// instructions in the same order, so at K = 1 they give the same bits
// (int8 and bf16 at every t this route takes; f32 / f64 but at kernel 9's
// t = 128 and 256).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace core {

constexpr int kMaxK = 16;     // candidates a launch takes
constexpr int kThreads = 256;  // outputs a block takes at once
constexpr int kRun = 16;       // products summed from zero before adding
constexpr int kChunk = 128;    // positions of u staged at a time

__device__ __forceinline__ float value(int8_t x) { return (float)x; }
__device__ __forceinline__ float value(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ double value(double x) { return x; }

// Where tile k (in storage order) of problem q starts, and its row pitch.
//   Flat (kernel 1): (P, 2t, S) storage, tile k at column k t, pitch S;
//   TileMajor (kernel 9): (P, n, 2t, t) storage, n = nt (nt + 1) / 2,
//     tile k the contiguous (2t, t) block, pitch t.
struct Flat {
  long long S;
  int t;
  __device__ __forceinline__ size_t at(int q, int k, int n) const {
    return (size_t)q * (size_t)(2 * t) * (size_t)S + (size_t)k * t;
  }
  __device__ __forceinline__ size_t pitch() const { return (size_t)S; }
};

struct TileMajor {
  int t;
  __device__ __forceinline__ size_t at(int q, int k, int n) const {
    return ((size_t)q * n + k) * (size_t)(2 * t) * (size_t)t;
  }
  __device__ __forceinline__ size_t pitch() const { return (size_t)t; }
};

__device__ __forceinline__ int tile_offset(int r, int nt) {
  return r * nt - r * (r - 1) / 2;
}

// a 16-byte row segment of the staged values
template <typename A>
struct alignas(16) Quad {
  static constexpr int kN = 16 / (int)sizeof(A);
  A v[kN];
};

// S: storage; UT: u's type (bf16 for int8 and bf16 storage, else S); A:
// the runs' type (f32, f64 for f64 storage) and the output's. Grid (nt,
// B); out (B, K, 2m).
template <typename S, typename UT, typename A, typename Addr>
__global__ void __launch_bounds__(kThreads) tri_matvec_core_kernel(
    const S* __restrict__ tri, const int* __restrict__ idx,
    const UT* __restrict__ U, A* __restrict__ out, int K, int nt,
    const Addr addr, float scale) {
  constexpr int V = Quad<A>::kN;
  __shared__ Quad<A> us[kChunk * kMaxK / V];  // [position][candidate]
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int t = addr.t;
  const int m = nt * t;
  const int n = nt * (nt + 1) / 2;
  const int q = idx[b];
  const size_t ld = addr.pitch();
  const UT* u = U + (size_t)b * K * m;
  const int off_j = tile_offset(j, nt);
  // the candidates staged a position: K, up to whole 16-byte segments
  const int KV = (K + V - 1) / V * V;
  for (int o0 = 0; o0 < 2 * t; o0 += blockDim.x) {
    const int o = o0 + threadIdx.x;
    const bool active = o < 2 * t;
    const int h = o / t, l = o % t;
    double acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.0;
    for (int w = 0; w < nt; ++w) {
      // tile w of the walk: forward (j, j + w), then transposed (r, j)
      const bool fwd = w < nt - j;
      const int blk = fwd ? j + w : w - (nt - j);  // its block of u
      const S* base =
          tri + addr.at(q, fwd ? off_j + w : tile_offset(blk, nt) + j - blk,
                        n);
      const S* x = fwd ? base + (size_t)o * ld
                       : base + (size_t)(h * t) * ld + l;
      const size_t step = fwd ? 1 : ld;
      const UT* ub = u + (size_t)blk * t;
      for (int p0 = 0; p0 < t; p0 += kChunk) {
        const int np = min(kChunk, t - p0);
        __syncthreads();  // the previous chunk's reads are done
        A* ul = reinterpret_cast<A*>(us);
        for (int e = threadIdx.x; e < np * KV; e += blockDim.x) {
          const int k = e / np, i = e % np;
          ul[i * kMaxK + k] =
              k < K ? (A)value(ub[(size_t)k * m + p0 + i]) : A(0);
        }
        __syncthreads();
        if (!active) continue;
        for (int i0 = 0; i0 < np; i0 += kRun) {
          A run[kMaxK];
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) run[k] = A(0);
          const int i1 = min(np, i0 + kRun);
          for (int i = i0; i < i1; ++i) {
            const A s = (A)value(x[(size_t)(p0 + i) * step]);
            if (s == A(0)) continue;
            const Quad<A>* ur = us + i * (kMaxK / V);
#pragma unroll
            for (int g = 0; g < kMaxK / V; ++g) {
              if (g * V >= K) break;
              const Quad<A> v = ur[g];
#pragma unroll
              for (int e = 0; e < V; ++e) run[g * V + e] += s * v.v[e];
            }
          }
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) acc[k] += (double)run[k];
        }
      }
    }
    if (!active) continue;
    A* ob = out + (size_t)b * K * 2 * m + (size_t)h * m + (size_t)j * t + l;
#pragma unroll
    for (int k = 0; k < kMaxK; ++k)
      if (k < K) ob[(size_t)k * 2 * m] = (A)acc[k] * (A)scale;
  }
}

// One launch: B lanes, K <= 16 candidates, blocks of 2t threads rounded
// up to a warp (at most kThreads; more outputs take more groups).
template <typename S, typename UT, typename A, typename Addr>
int launch_core(const void* tri, const void* idx, const void* U, void* out,
                int B, int K, int nt, const Addr& addr, float scale,
                cudaStream_t stream) {
  if (K < 1 || K > kMaxK || B < 1 || B > 65535 || nt < 1 || addr.t < 1)
    return (int)cudaErrorInvalidValue;
  const int want = (2 * addr.t + 31) / 32 * 32;
  const int threads = want < kThreads ? want : kThreads;
  tri_matvec_core_kernel<S, UT, A, Addr><<<dim3(nt, B), threads, 0, stream>>>(
      (const S*)tri, (const int*)idx, (const UT*)U, (A*)out, K, nt, addr,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace core
