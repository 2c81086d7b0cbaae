// The block body of the stacked [M; C] build, shared by stored_build.cu
// (kernel 4) and build_probe.cu (its five ablations): one block per
// (kCols columns, kRows rows, problem). The block's row endpoints sit in
// shared memory, each thread holds one output column's endpoints in
// registers and walks the rows, so each output row is written as
// consecutive elements by consecutive threads (coalesced). Each step
// writes both halves: row gr of M and row m + gr of C.
//
// A score functor takes a row's and a column's endpoints in both sets,
// (r1, c1) and (r2, c2), each Score::D values, and returns the score s:
//   int8: M = clip(rint(127 s), 0, 127) (round half to even, as
//         jnp.round), C = 127;
//   bf16: M = bf16(s) rounded to nearest even from the f32 score, C = 1;
//   keep = distinct & off-diagonal & row, col < m_true[w] & s > affeps,
//   and M = C = 0 elsewhere.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// the grid of the stacked build of W problems of m associations
inline dim3 stored_build_grid(int W, int m) {
  return dim3((m + kCols - 1) / kCols, (m + kRows - 1) / kRows, W);
}

}  // namespace
