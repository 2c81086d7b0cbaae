// Flat upper-triangle int8 or bf16 [M; C] build with one thread block per
// problem, for Hopper.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:build_tri_pallas_fused
// (:567-655), whose grid had one program per problem that computed all T
// upper tiles of its problem in one unrolled loop (the TPU's per-program
// cost made the per-tile grid of build_tri_pallas expensive). Here block
// w loops over its problem's tiles in storage order and runs, for each,
// the same per-tile body as tri_build.cu (tri_tile_build.cuh): the two
// kernels write the same bytes, for both built-in invariants.
//
// What bounds it on this card: the same work as tri_build.cu (the int8
// output, 671 MB at W=512, m=1024: 0.2 ms at 3.35 TB/s; operations for
// the point-normal score). The one-block-per-problem grid fills the card
// only when W is large: W=512 blocks on 132 SMs, a few resident on each,
// each block walking T tiles in order. Nothing carries over between a
// problem's tiles except the shared row buffer, reloaded per tile; the
// loop takes the place of the TPU's static unroll. No pipeline selects
// it (the JAX package found it a wash against the per-tile grid).

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"
#include "tri_tile_build.cuh"

namespace {

template <typename Score, typename T>
__global__ void __launch_bounds__(256) tri_build_fused_kernel(
    const Score score, const float* __restrict__ P1,
    const float* __restrict__ P2, const int* __restrict__ A,
    const int* __restrict__ m_trues, T* __restrict__ out, int m, int t,
    long long S, float affeps) {
  constexpr int D = Score::D;
  __shared__ TileRows<D> rows;

  const int w = blockIdx.x;  // problem
  const int nt = m / t;
  const float* p1 = P1 + (size_t)w * m * D;
  const float* p2 = P2 + (size_t)w * m * D;
  const int* a = A + (size_t)w * m * 2;
  T* ow = out + (size_t)w * (size_t)(2 * t) * (size_t)S;
  const int lim = m_trues[w];
  int k = 0;
  for (int r = 0; r < nt; ++r) {
    for (int c = r; c < nt; ++c, ++k) {
      build_tri_tile(score, p1, p2, a, lim, r, c, t, S, affeps,
                     ow + (size_t)k * t, rows);
    }
  }
}

template <typename T, typename Score>
int launch(const Score& score, const void* P1, const void* P2, const void* A,
           const void* m_trues, void* out, int W, int m, int t, long long S,
           float affeps, void* stream) {
  tri_build_fused_kernel<Score, T><<<W, 256, 0, (cudaStream_t)stream>>>(
      score, (const float*)P1, (const float*)P2, (const int*)A,
      (const int*)m_trues, (T*)out, m, t, S, affeps);
  return (int)cudaGetLastError();
}

template <typename T>
int build(const void* P1, const void* P2, const void* A, const void* m_trues,
          void* out, int W, int m, int t, long long S, int kind, double p0,
          double p1, double p2, double p3, double affeps, void* stream) {
  if (t < 1 || t > kMaxTile || m % t || W < 1)
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

// The arguments of tri_build_int8 (tri_build.cu).
int tri_build_fused_int8(const void* P1, const void* P2, const void* A,
                         const void* m_trues, void* out, int W, int m, int t,
                         long long S, int kind, double p0, double p1,
                         double p2, double p3, double affeps, void* stream) {
  return build<int8_t>(P1, P2, A, m_trues, out, W, m, t, S, kind, p0, p1, p2,
                       p3, affeps, stream);
}

// The arguments of tri_build_bf16 (tri_build.cu).
int tri_build_fused_bf16(const void* P1, const void* P2, const void* A,
                         const void* m_trues, void* out, int W, int m, int t,
                         long long S, int kind, double p0, double p1,
                         double p2, double p3, double affeps, void* stream) {
  return build<__nv_bfloat16>(P1, P2, A, m_trues, out, W, m, t, S, kind, p0,
                              p1, p2, p3, affeps, stream);
}

}  // extern "C"
