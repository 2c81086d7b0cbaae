// Fused pattern dual matvec for Hopper: Mu = M u and Cu = (M > 0) u from
// one read of a dense (B, m, m) M, f32 or bf16, with f32 u and outputs.
//
// Replaces the TPU kernel clipper_tpu/ops/fused_matvec.py:
// pattern_dual_matvec (kernel :28-35, launch :55-91), the batched engine's
// matvec="fused": C is exactly the 0/1 pattern of M there, so C u comes
// from the same tile of M in registers. Like the JAX kernel it converts M
// to f32 and sums in f32.
//
// What bounds it on this card: the read of M, B m^2 elements (2.15 GB of
// f32 at B=512, m=1024: 0.64 ms at 3.35 TB/s; bf16 half that) against
// 4 B m^2 flops (2.1 GFLOP, 0.03 ms at 67 TFLOP/s): bytes. Design: one warp
// per row, kWarps rows a block, the block's u staged in shared memory; a
// lane reads 16 bytes of its row at a time (4 f32 or 8 bf16 values) and
// the matching u values as one 16-byte shared load, so a warp streams
// 512 contiguous bytes per step. Each lane sums its elements in a fixed
// order and the warp combines the 32 partials by a fixed shuffle tree: no
// atomics, and a rerun is bit-identical.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                     // rows a block
constexpr int kMaxSmem = 227 * 1024;          // a block's shared memory

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16 bytes of a row as f32 values
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&x)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      x[2 * k] = f.x;
      x[2 * k + 1] = f.y;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) pattern_matvec_kernel(
    const T* __restrict__ M, const float* __restrict__ u,
    float* __restrict__ Mu, float* __restrict__ Cu, int m, int vec) {
  extern __shared__ float4 us4[];
  float* us = reinterpret_cast<float*>(us4);
  const int b = blockIdx.y;
  const float* ub = u + (size_t)b * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) us[j] = ub[j];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;
  const T* Mr = M + ((size_t)b * m + row) * m;
  constexpr int N = Vec<T>::N;
  float am = 0.f, ac = 0.f;
  int j0 = 0;
  if (vec) {  // rows are 16-byte aligned: m % N == 0, aligned base
    const int nv = m / N;
    for (int v = lane; v < nv; v += 32) {
      float x[N];
      Vec<T>::load(Mr + (size_t)v * N, x);
#pragma unroll
      for (int h = 0; h < N / 4; ++h) {
        const float4 uu = us4[v * (N / 4) + h];
        const float uj[4] = {uu.x, uu.y, uu.z, uu.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float xk = x[4 * h + k];
          am = fmaf(xk, uj[k], am);
          ac += xk > 0.f ? uj[k] : 0.f;
        }
      }
    }
    j0 = nv * N;
  }
  for (int j = j0 + lane; j < m; j += 32) {
    const float xk = to_float(Mr[j]);
    am = fmaf(xk, us[j], am);
    ac += xk > 0.f ? us[j] : 0.f;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    am += __shfl_xor_sync(0xffffffffu, am, off);
    ac += __shfl_xor_sync(0xffffffffu, ac, off);
  }
  if (lane == 0) {
    Mu[(size_t)b * m + row] = am;
    Cu[(size_t)b * m + row] = ac;
  }
}

template <typename T>
int launch(const void* M, const void* u, void* Mu, void* Cu, int B, int m,
           int aligned, void* stream) {
  const int smem = m * (int)sizeof(float);
  if (B < 1 || B > 65535 || m < 1 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pattern_matvec_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = aligned && m % Vec<T>::N == 0;
  const dim3 grid((m + kWarps - 1) / kWarps, B);
  pattern_matvec_kernel<T><<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const T*)M, (const float*)u, (float*)Mu, (float*)Cu, m, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// M (B, m, m) f32 or bf16, u (B, m) f32 -> Mu, Cu (B, m) f32. aligned: M's
// base address is a multiple of 16 bytes.
int pattern_matvec_f32(const void* M, const void* u, void* Mu, void* Cu,
                       int B, int m, int aligned, void* stream) {
  return launch<float>(M, u, Mu, Cu, B, m, aligned, stream);
}

int pattern_matvec_bf16(const void* M, const void* u, void* Mu, void* Cu,
                        int B, int m, int aligned, void* stream) {
  return launch<__nv_bfloat16>(M, u, Mu, Cu, B, m, aligned, stream);
}

}  // extern "C"
