// Kernel 2's entries for the two built-in invariants: the flat-triangle
// [M; C] build of tri_build.cuh (where its design and what it replaces
// are set out), with the score chosen by kind (invariants.kernel_score).

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"
#include "tri_build.cuh"

namespace {

template <typename T>
int build(const void* P1, const void* P2, const void* A, const void* m_trues,
          void* out, int W, int m, int t, long long S, int kind, double p0,
          double p1, double p2, double p3, double affeps, void* stream) {
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return tri_build_run<T, EuclidScore<float>>(p, P1, P2, A, m_trues, out,
                                                W, m, t, S, affeps, stream);
  if (kind == 1)
    return tri_build_run<T, PointNormalScore<float>>(
        p, P1, P2, A, m_trues, out, W, m, t, S, affeps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// P1, P2 (W, m, D) f32 with D = 3 (kind 0, Euclidean) or 6 (kind 1,
// point-normal); A (W, m, 2) int32; m_trues (W,) int32; out (W, 2t, S)
// int8 with S = t * nt (nt + 1) / 2, 16-byte aligned. p0..p3: the score's
// parameters (invariants.kernel_score).
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
