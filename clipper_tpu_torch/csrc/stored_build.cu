// Fused affinity build straight into dense stacked [M; C] storage, int8
// or bf16, for Hopper: the Euclidean and the point-normal invariants.
//
// Replaces the TPU kernel clipper_tpu/ops/affinity_pallas.py:
// score_consistency_stored_pallas (:107-242). Like it, it evaluates the
// score, the masks and the quantization of every (row, column) pair of
// each problem and writes the (2m, m) storage of problem w: rows 0..m-1
// hold M, rows m..2m-1 hold C, both triangles.
//
//   int8: M = clip(rint(127 s), 0, 127) (round half to even, as
//         jnp.round), C = 127;
//   bf16: M = bf16(s) rounded to nearest even from the f32 score (the JAX
//         kernel keeps s in f32 and casts once), C = 1;
//   keep = distinct & off-diagonal & row, col < m_true[w] & s > affeps,
//   and M = C = 0 elsewhere.
//
// The score is a functor of euclid_score.cuh ((W, m, 3) endpoints) or
// pointnormal_score.cuh ((W, m, 6)), the arithmetic of tri_build.cu,
// built with --fmad=false as well: its int8 codes equal the plain
// build's. The score of (b, a) equals that of (a, b) bit for bit, so the
// output equals its transpose. Other invariants raise on CUDA, as for
// tri_build.cu.
//
// What bounds it on this card: at W=512, m=1024 the 1.07 GB of int8
// output (0.32 ms at 3.35 TB/s) against ~30 f32 operations on each of the
// 537 M entries (0.24 ms at 67 TFLOP/s): bytes (the point-normal score's
// ~60 operations and four transcendentals: operations). Design, the
// simple one of tri_build.cu: one block per (column tile, row tile,
// problem); the block's kRows row endpoints sit in shared memory, each of
// its kCols threads holds one output column's endpoints in registers and
// walks the rows, so each output row is written as consecutive elements
// by consecutive threads (coalesced). m need not divide by a tile: the edge
// tiles check their bounds instead of the TPU kernel's padding. Every pair
// is computed twice, once for each triangle; computing it once and writing
// the tile and its transpose is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"

namespace {

constexpr int kCols = 256;  // threads of a block: one output column each
constexpr int kRows = 64;   // rows a block walks

__device__ __forceinline__ void put(int8_t* M, int8_t* C, bool keep,
                                    float s) {
  int8_t mq = 0, cq = 0;
  if (keep) {
    const float q = rintf(__fmul_rn(s, 127.f));
    mq = (int8_t)fminf(fmaxf(q, 0.f), 127.f);
    cq = 127;
  }
  *M = mq;
  *C = cq;
}

__device__ __forceinline__ void put(__nv_bfloat16* M, __nv_bfloat16* C,
                                    bool keep, float s) {
  *M = __float2bfloat16_rn(keep ? s : 0.f);
  *C = __float2bfloat16_rn(keep ? 1.f : 0.f);
}

template <typename Score, typename T>
__global__ void __launch_bounds__(kCols) stored_build_kernel(
    const Score score, const float* __restrict__ P1,
    const float* __restrict__ P2, const int* __restrict__ A,
    const int* __restrict__ m_trues, T* __restrict__ out, int m,
    float affeps) {
  constexpr int D = Score::D;
  __shared__ float r1[kRows * D];
  __shared__ float r2[kRows * D];
  __shared__ int ra[kRows * 2];

  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kRows;
  const int w = blockIdx.z;
  const int rows = min(kRows, m - r0);
  const int lim = m_trues[w];

  const float* p1 = P1 + (size_t)w * m * D;
  const float* p2 = P2 + (size_t)w * m * D;
  const int* a = A + (size_t)w * m * 2;
  for (int q = threadIdx.x; q < rows * D; q += blockDim.x) {
    r1[q] = p1[(size_t)r0 * D + q];
    r2[q] = p2[(size_t)r0 * D + q];
  }
  for (int q = threadIdx.x; q < rows * 2; q += blockDim.x)
    ra[q] = a[(size_t)r0 * 2 + q];
  __syncthreads();

  const int gc = c0 + threadIdx.x;
  if (gc >= m) return;
  float c1[D], c2[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    c1[e] = p1[(size_t)gc * D + e];
    c2[e] = p2[(size_t)gc * D + e];
  }
  const int ca0 = a[gc * 2], ca1 = a[gc * 2 + 1];
  T* ob = out + (size_t)w * 2 * m * m;
  // unrolled by hand: the compiler leaves this loop rolled, and rolled it
  // runs about 20% slower on the H100 (PERF.md, kernel row 4)
#pragma unroll 4
  for (int i = 0; i < rows; ++i) {
    const int gr = r0 + i;
    const float s = score(r1 + i * D, c1, r2 + i * D, c2);
    const bool distinct = !(ra[i * 2] == ca0 || ra[i * 2 + 1] == ca1);
    const bool keep =
        distinct && gr != gc && gr < lim && gc < lim && s > affeps;
    put(ob + (size_t)gr * m + gc, ob + (size_t)(m + gr) * m + gc, keep, s);
  }
}

template <typename T, typename Score>
int launch(const Score& score, const void* P1, const void* P2, const void* A,
           const void* m_trues, void* out, int W, int m, float affeps,
           void* stream) {
  const dim3 grid((m + kCols - 1) / kCols, (m + kRows - 1) / kRows, W);
  stored_build_kernel<Score, T><<<grid, kCols, 0, (cudaStream_t)stream>>>(
      score, (const float*)P1, (const float*)P2, (const int*)A,
      (const int*)m_trues, (T*)out, m, affeps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* P1, const void* P2, const void* A,
             const void* m_trues, void* out, int W, int m, int kind,
             double p0, double p1, double p2, double p3, double affeps,
             void* stream) {
  if (W < 1 || m < 1 || W > 65535) return (int)cudaErrorInvalidValue;
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return launch<T>(EuclidScore<float>(p), P1, P2, A, m_trues, out, W, m,
                     (float)affeps, stream);
  if (kind == 1)
    return launch<T>(PointNormalScore<float>(p), P1, P2, A, m_trues, out, W,
                     m, (float)affeps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// P1, P2 (W, m, D) f32 with D = 3 (kind 0, Euclidean) or 6 (kind 1,
// point-normal); A (W, m, 2) int32; m_trues (W,) int32; out (W, 2m, m)
// int8 or bf16. p0..p3: the score's parameters (invariants.kernel_score).
int stored_build_int8(const void* P1, const void* P2, const void* A,
                      const void* m_trues, void* out, int W, int m, int kind,
                      double p0, double p1, double p2, double p3,
                      double affeps, void* stream) {
  return dispatch<int8_t>(P1, P2, A, m_trues, out, W, m, kind, p0, p1, p2,
                          p3, affeps, stream);
}

int stored_build_bf16(const void* P1, const void* P2, const void* A,
                      const void* m_trues, void* out, int W, int m, int kind,
                      double p0, double p1, double p2, double p3,
                      double affeps, void* stream) {
  return dispatch<__nv_bfloat16>(P1, P2, A, m_trues, out, W, m, kind, p0, p1,
                                 p2, p3, affeps, stream);
}

}  // extern "C"
