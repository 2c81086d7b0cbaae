// Kernel 6's entries for the two built-in invariants: the dense build of
// affinity_build.cuh (where its design and what it replaces are set out),
// with the score chosen by kind (invariants.kernel_score).

#include <cuda_runtime.h>
#include <stdint.h>

#include "affinity_build.cuh"
#include "euclid_score.cuh"
#include "pointnormal_score.cuh"

namespace {

template <typename T>
int dispatch(const void* P1, const void* P2, const void* A, void* M,
             void* C, int m, int kind, double p0, double p1, double p2,
             double p3, double affeps, void* stream) {
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return affinity_build_run<T, EuclidScore>(p, P1, P2, A, M, C, m, affeps,
                                              stream);
  if (kind == 1)
    return affinity_build_run<T, PointNormalScore>(p, P1, P2, A, M, C, m,
                                                   affeps, stream);
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
