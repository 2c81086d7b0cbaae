// Fused Euclidean affinity build straight into flat upper-triangle int8
// storage, for Hopper.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:build_tri_pallas
// (:463-564). Like it, each block evaluates ONE upper tile (r, c) of one
// problem w: scores, masks and quantization, and writes that tile's
// (2t, t) [M; C] column block at column off * t of problem w's (2t, S)
// storage.
//
// Specific to the Euclidean invariant on 3-D points (invariants/
// euclidean.py); the JAX kernel traced any symmetric invariant's
// score_block_t. Other invariants build through the plain PyTorch path on
// the CPU and raise on CUDA.
//
// Numerics follow the JAX arithmetic step by step, because they decide the
// +-1 int8 codes and the 0/127 C codes: the score of euclid_score.cuh, then
//   keep = distinct & off-diagonal & row, col < m_true & s > (float)affeps;
//   M = clip(rint(127 s), 0, 127) (round half to even, as jnp.round);
//   C = 127.
// expf may differ from XLA's exp by an ulp, which can move an M code by one
// at a rounding tie; the C half is exact.
//
// What bounds it on this card: the 671 MB of int8 output at W=512, m=1024
// (0.2 ms at 3.35 TB/s) against ~30 f32 operations per entry (~10 GFLOP,
// 0.15 ms at 67 TFLOP/s): bytes, narrowly. Design: the block's t row
// endpoints sit in shared memory, each thread holds one output column's
// endpoints in registers and walks the t rows, so every row of the tile is
// written as t consecutive bytes by consecutive threads (coalesced).

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"

namespace {

constexpr int kMaxTile = 256;

__global__ void __launch_bounds__(256) tri_build_int8_kernel(
    const float* __restrict__ P1, const float* __restrict__ P2,
    const int* __restrict__ A, const int* __restrict__ m_trues,
    int8_t* __restrict__ out, int m, int t, long long S, float s2, float eps,
    float affeps, float mindist) {
  __shared__ float r1[kMaxTile * 3];
  __shared__ float r2[kMaxTile * 3];
  __shared__ int ra[kMaxTile * 2];

  const int k = blockIdx.x;  // upper tile, storage order
  const int w = blockIdx.y;  // problem
  const int nt = m / t;
  int r = 0, rem = k;
  while (rem >= nt - r) {
    rem -= nt - r;
    ++r;
  }
  const int c = r + rem;
  const int lim = m_trues[w];

  const float* p1 = P1 + (size_t)w * m * 3;
  const float* p2 = P2 + (size_t)w * m * 3;
  const int* a = A + (size_t)w * m * 2;
  for (int q = threadIdx.x; q < t * 3; q += blockDim.x) {
    r1[q] = p1[(size_t)r * t * 3 + q];
    r2[q] = p2[(size_t)r * t * 3 + q];
  }
  for (int q = threadIdx.x; q < t * 2; q += blockDim.x)
    ra[q] = a[(size_t)r * t * 2 + q];
  __syncthreads();

  int8_t* ob = out + (size_t)w * (size_t)(2 * t) * (size_t)S + (size_t)k * t;
  for (int l = threadIdx.x; l < t; l += blockDim.x) {
    const int gc = c * t + l;
    const float cx1 = p1[gc * 3], cy1 = p1[gc * 3 + 1], cz1 = p1[gc * 3 + 2];
    const float cx2 = p2[gc * 3], cy2 = p2[gc * 3 + 1], cz2 = p2[gc * 3 + 2];
    const int ca0 = a[gc * 2], ca1 = a[gc * 2 + 1];
    for (int i = 0; i < t; ++i) {
      const int gr = r * t + i;
      const float l1 =
          dist3(r1[i * 3], r1[i * 3 + 1], r1[i * 3 + 2], cx1, cy1, cz1);
      const float l2 =
          dist3(r2[i * 3], r2[i * 3 + 1], r2[i * 3 + 2], cx2, cy2, cz2);
      const float s = euclid_score(l1, l2, s2, eps, mindist);
      const bool distinct = !(ra[i * 2] == ca0 || ra[i * 2 + 1] == ca1);
      const bool keep = distinct && gr != gc && gr < lim && gc < lim &&
                        s > affeps;
      int8_t mq = 0, cq = 0;
      if (keep) {
        const float q = rintf(__fmul_rn(s, 127.f));
        mq = (int8_t)fminf(fmaxf(q, 0.f), 127.f);
        cq = 127;
      }
      ob[(size_t)i * S + l] = mq;
      ob[(size_t)(t + i) * S + l] = cq;
    }
  }
}

}  // namespace

extern "C" {

// P1, P2 (W, m, 3) f32; A (W, m, 2) int32; m_trues (W,) int32;
// out (W, 2t, S) int8 with S = t * nt (nt + 1) / 2.
int tri_build_int8(const void* P1, const void* P2, const void* A,
                   const void* m_trues, void* out, int W, int m, int t,
                   long long S, float s2, float eps, float affeps,
                   float mindist, void* stream) {
  if (t < 1 || t > kMaxTile || m % t) return (int)cudaErrorInvalidValue;
  const int nt = m / t;
  const dim3 grid(nt * (nt + 1) / 2, W);
  tri_build_int8_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const float*)P1, (const float*)P2, (const int*)A,
      (const int*)m_trues, (int8_t*)out, m, t, S, s2, eps, affeps, mindist);
  return (int)cudaGetLastError();
}

}  // extern "C"
