// Fused affinity build straight into flat upper-triangle int8 or bf16
// storage, for Hopper: the Euclidean and the point-normal invariants.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:build_tri_pallas
// (:463-564). Like it, each block evaluates ONE upper tile (r, c) of one
// problem w: scores, masks and quantization, and writes that tile's
// (2t, t) [M; C] column block at column k * t of problem w's (2t, S)
// storage. The per-tile body is tri_tile_build.cuh's, shared with
// tri_build_fused.cu (one block per problem), so the two write the same
// bytes.
//
// The JAX kernel traced any symmetric invariant's score_block_t; this one
// takes the two built-in invariants' scores as functors
// (euclid_score.cuh, (W, m, 3) endpoints; pointnormal_score.cuh,
// (W, m, 6)), which repeat the plain PyTorch arithmetic step by step under
// --fmad=false. Other invariants build through the plain version on the
// CPU and raise on CUDA. expf and acosf may differ from XLA's by an ulp,
// which can move an M code by one at a rounding tie; the C half is exact.
//
// What bounds it on this card: the 671 MB of int8 output at W=512, m=1024
// (0.2 ms at 3.35 TB/s; bf16 storage doubles it) against ~30 f32
// operations per Euclidean entry (~10 GFLOP, 0.15 ms at 67 TFLOP/s):
// bytes, narrowly; the point-normal score's ~60 operations and four
// transcendentals make it bound by operations. Design: the block's t row
// endpoints sit in shared memory, each thread holds one output column's
// endpoints in registers and walks the t rows, so every row of the tile is
// written as t consecutive elements by consecutive threads (coalesced).

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"
#include "tri_tile_build.cuh"

namespace {

template <typename Score, typename T>
__global__ void __launch_bounds__(256) tri_build_kernel(
    const Score score, const float* __restrict__ P1,
    const float* __restrict__ P2, const int* __restrict__ A,
    const int* __restrict__ m_trues, T* __restrict__ out, int m, int t,
    long long S, float affeps) {
  constexpr int D = Score::D;
  __shared__ TileRows<D> rows;

  const int k = blockIdx.x;  // upper tile, storage order
  const int w = blockIdx.y;  // problem
  const int nt = m / t;
  int r = 0, rem = k;
  while (rem >= nt - r) {
    rem -= nt - r;
    ++r;
  }
  build_tri_tile(score, P1 + (size_t)w * m * D, P2 + (size_t)w * m * D,
                 A + (size_t)w * m * 2, m_trues[w], r, r + rem, t, S, affeps,
                 out + (size_t)w * (size_t)(2 * t) * (size_t)S + (size_t)k * t,
                 rows);
}

template <typename T, typename Score>
int launch(const Score& score, const void* P1, const void* P2, const void* A,
           const void* m_trues, void* out, int W, int m, int t, long long S,
           float affeps, void* stream) {
  const int nt = m / t;
  const dim3 grid(nt * (nt + 1) / 2, W);
  tri_build_kernel<Score, T><<<grid, 256, 0, (cudaStream_t)stream>>>(
      score, (const float*)P1, (const float*)P2, (const int*)A,
      (const int*)m_trues, (T*)out, m, t, S, affeps);
  return (int)cudaGetLastError();
}

template <typename T>
int build(const void* P1, const void* P2, const void* A, const void* m_trues,
          void* out, int W, int m, int t, long long S, int kind, double p0,
          double p1, double p2, double p3, double affeps, void* stream) {
  if (t < 1 || t > kMaxTile || m % t || W < 1 || W > 65535)
    return (int)cudaErrorInvalidValue;
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return launch<T>(EuclidScore<float>(p), P1, P2, A, m_trues, out, W, m, t,
                     S, (float)affeps, stream);
  if (kind == 1)
    return launch<T>(PointNormalScore<float>(p), P1, P2, A, m_trues, out, W,
                     m, t, S, (float)affeps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// P1, P2 (W, m, D) f32 with D = 3 (kind 0, Euclidean) or 6 (kind 1,
// point-normal); A (W, m, 2) int32; m_trues (W,) int32; out (W, 2t, S)
// int8 with S = t * nt (nt + 1) / 2. p0..p3: the score's parameters
// (invariants.kernel_score).
int tri_build_int8(const void* P1, const void* P2, const void* A,
                   const void* m_trues, void* out, int W, int m, int t,
                   long long S, int kind, double p0, double p1, double p2,
                   double p3, double affeps, void* stream) {
  return build<int8_t>(P1, P2, A, m_trues, out, W, m, t, S, kind, p0, p1, p2,
                       p3, affeps, stream);
}

// As tri_build_int8, out (W, 2t, S) bf16.
int tri_build_bf16(const void* P1, const void* P2, const void* A,
                   const void* m_trues, void* out, int W, int m, int t,
                   long long S, int kind, double p0, double p1, double p2,
                   double p3, double affeps, void* stream) {
  return build<__nv_bfloat16>(P1, P2, A, m_trues, out, W, m, t, S, kind, p0,
                              p1, p2, p3, affeps, stream);
}

}  // extern "C"
