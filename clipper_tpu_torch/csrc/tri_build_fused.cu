// Kernel 8's entries for the two built-in invariants: the one-block-a-
// problem flat-triangle build of tri_build_fused.cuh (where its design and
// what it replaces are set out), with the score chosen by kind
// (invariants.kernel_score), and which of its branches a problem takes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"
#include "tri_build_fused.cuh"

namespace {

template <typename T>
int build(const void* P1, const void* P2, const void* A, const void* m_trues,
          void* out, int W, int m, int t, long long S, int kind, double p0,
          double p1, double p2, double p3, double affeps, void* stream) {
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return tri_build_fused_run<T, EuclidScore<float>>(
        p, P1, P2, A, m_trues, out, W, m, t, S, affeps, stream);
  if (kind == 1)
    return tri_build_fused_run<T, PointNormalScore<float>>(
        p, P1, P2, A, m_trues, out, W, m, t, S, affeps, stream);
  return (int)cudaErrorInvalidValue;
}

// the built-in scores' records: 32 and 64 bytes (_kernels.record_bytes)
static_assert(fused_rec<EuclidScore<float>>() == 32, "Euclidean record");
static_assert(fused_rec<PointNormalScore<float>>() == 64,
              "point-normal record");

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

// 1 where a block stages its problem's endpoints whole for m associations
// of records of rec bytes (_kernels.record_bytes: 32 Euclidean, 64
// point-normal) and storage bf16 (0 int8, 1 bf16), 0 where each unit
// stages its pair's two sub-tiles; -1 where the device cannot be asked.
int tri_build_fused_whole(int m, int rec, int bf16) {
  return bf16 ? fused_whole<__nv_bfloat16>(m, rec)
              : fused_whole<int8_t>(m, rec);
}

}  // extern "C"
