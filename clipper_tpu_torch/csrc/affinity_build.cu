// Dense affinity build of one problem: (m, m) M and its 0/1 pattern C in
// the working precision (f32 or f64), for Hopper: the Euclidean and the
// point-normal invariants.
//
// Replaces the TPU kernel clipper_tpu/ops/affinity_pallas.py:
// build_affinity_pallas (:42-104). Like it, it evaluates every (row,
// column) pair's score from the gathered (m, D) endpoints and writes
//   keep = distinct & off-diagonal & s > (T)affeps;
//   M = keep ? s : 0 (so a zero diagonal), C = keep ? 1 : 0,
// the function ops.affinity.pairwise_from_endpoints computes (the
// reference's src/clipper.cpp:21-65). The JAX kernel padded m to its
// tile; here the edge tiles check their bounds, for any m.
//
// The score is a functor of euclid_score.cuh (D = 3) or
// pointnormal_score.cuh (D = 6) in T = float or double, built with
// --fmad=false: the plain version's IEEE steps in the same order, so M
// equals it bit for bit where the CUDA math library's exp, acos and sqrt
// are the functions PyTorch's CUDA kernels call; C is exact.
//
// What bounds it on this card: the output write, 8 bytes a pair in f32
// (200 MB at m=5000: 0.06 ms at 3.35 TB/s) against ~56 f32 operations a
// pair for the point-normal score, four of them transcendentals (1.4
// GFLOP: 0.02 ms at 67 TFLOP/s) — bytes, for either invariant. Design,
// that of stored_build.cu: one block per (column tile of kCols, row tile
// of kRows); the block's row endpoints sit in shared memory, each thread
// holds one output column's endpoints in registers and walks the rows, so
// each output row is written as consecutive elements by consecutive
// threads (coalesced).

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"

namespace {

constexpr int kCols = 256;  // threads of a block: one output column each
constexpr int kRows = 64;   // rows a block walks

template <typename Score, typename T>
__global__ void __launch_bounds__(kCols) affinity_build_kernel(
    const Score score, const T* __restrict__ P1, const T* __restrict__ P2,
    const int* __restrict__ A, T* __restrict__ M, T* __restrict__ C, int m,
    T affeps) {
  constexpr int D = Score::D;
  __shared__ T r1[kRows * D];
  __shared__ T r2[kRows * D];
  __shared__ int ra[kRows * 2];

  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kRows;
  const int rows = min(kRows, m - r0);
  for (int q = threadIdx.x; q < rows * D; q += blockDim.x) {
    r1[q] = P1[(size_t)r0 * D + q];
    r2[q] = P2[(size_t)r0 * D + q];
  }
  for (int q = threadIdx.x; q < rows * 2; q += blockDim.x)
    ra[q] = A[(size_t)r0 * 2 + q];
  __syncthreads();

  const int gc = c0 + threadIdx.x;
  if (gc >= m) return;
  T c1[D], c2[D];
#pragma unroll
  for (int e = 0; e < D; ++e) {
    c1[e] = P1[(size_t)gc * D + e];
    c2[e] = P2[(size_t)gc * D + e];
  }
  const int ca0 = A[(size_t)gc * 2], ca1 = A[(size_t)gc * 2 + 1];
  for (int i = 0; i < rows; ++i) {
    const int gr = r0 + i;
    const T s = score(r1 + i * D, c1, r2 + i * D, c2);
    const bool distinct = !(ra[i * 2] == ca0 || ra[i * 2 + 1] == ca1);
    const bool keep = distinct && gr != gc && s > affeps;
    M[(size_t)gr * m + gc] = keep ? s : (T)0;
    C[(size_t)gr * m + gc] = keep ? (T)1 : (T)0;
  }
}

template <typename T, template <typename> class Score>
int launch(const double (&p)[4], const void* P1, const void* P2,
           const void* A, void* M, void* C, int m, double affeps,
           void* stream) {
  const dim3 grid((m + kCols - 1) / kCols, (m + kRows - 1) / kRows);
  affinity_build_kernel<Score<T>, T><<<grid, kCols, 0, (cudaStream_t)stream>>>(
      Score<T>(p), (const T*)P1, (const T*)P2, (const int*)A, (T*)M, (T*)C,
      m, (T)affeps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* P1, const void* P2, const void* A, void* M,
             void* C, int m, int kind, double p0, double p1, double p2,
             double p3, double affeps, void* stream) {
  if (m < 1 || (m + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return launch<T, EuclidScore>(p, P1, P2, A, M, C, m, affeps, stream);
  if (kind == 1)
    return launch<T, PointNormalScore>(p, P1, P2, A, M, C, m, affeps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// P1, P2 (m, D) in T with D = 3 (kind 0, Euclidean) or 6 (kind 1,
// point-normal); A (m, 2) int32; M, C (m, m) in T. p0..p3: the score's
// parameters (invariants.kernel_score).
int affinity_build_f32(const void* P1, const void* P2, const void* A,
                       void* M, void* C, int m, int kind, double p0,
                       double p1, double p2, double p3, double affeps,
                       void* stream) {
  return dispatch<float>(P1, P2, A, M, C, m, kind, p0, p1, p2, p3, affeps,
                         stream);
}

int affinity_build_f64(const void* P1, const void* P2, const void* A,
                       void* M, void* C, int m, int kind, double p0,
                       double p1, double p2, double p3, double affeps,
                       void* stream) {
  return dispatch<double>(P1, P2, A, M, C, m, kind, p0, p1, p2, p3, affeps,
                          stream);
}

}  // extern "C"
