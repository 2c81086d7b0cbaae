"""Two invariants of a user's own, with device scores for the build
kernels (invariants.DeviceScore, csrc/user_score.cuh), for the tests and
``chip_smoke.py``.

- :class:`UserEuclidean`: the built-in Euclidean invariant's arithmetic
  (invariants/euclidean.py) over d values a set (d = 3 by default), given
  as a user would give it: a score with ``operator()`` alone, so that the
  adaptor's screen passes every pair and its gate runs ``operator()``. It
  is not an EuclideanDistance, so it never reaches kind 0; its plain
  methods are the built-in's, so its codes equal the built-in kernel's.
- :class:`PlanarCauchy`: points in the plane (d = 2), s = 1 / (1 + c^2 /
  sigma^2) where c = |l1 - l2| < epsilon, else 0, with the pair body's
  stages: a square-root-free screen of the gate in f32 (euclid_score.cuh's
  screen_sq, which holds for planar lengths too), the exact gate in f64
  (kExactScreen), and the tail.

Each score's C++ repeats its plain PyTorch arithmetic step by step (the
builds run under --fmad=false), so the kernels' codes equal the plain
build's.
"""

from __future__ import annotations

import dataclasses

import torch

from clipper_tpu_torch.invariants.base import DeviceScore, PairwiseInvariant
from clipper_tpu_torch.invariants.euclidean import (EuclideanDistance,
                                                    EuclideanDistanceParams)
from clipper_tpu_torch.ops.pairwise import (cross_distance_matrix,
                                            pairwise_distance_matrix)

# UserEuclidean's score: the built-in's steps (euclid_score.cuh), over D
# coordinates summed from 0 in coordinate order; {d} is filled in
EUCLID_SOURCE = """
template <typename T>
struct Score {
  static constexpr int D = {d};
  using Value = T;
  T s2, eps, mindist;

  // p: (sigma^2, epsilon, mindist, unused), formed in double
  __host__ __device__ Score(const double (&p)[4])
      : s2((T)p[0]), eps((T)p[1]), mindist((T)p[2]) {}

  __device__ T operator()(const T* r1, const T* c1, const T* r2,
                          const T* c2) const {
    T q1 = T(0), q2 = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const T a = r1[k] - c1[k], b = r2[k] - c2[k];
      q1 = q1 + a * a;
      q2 = q2 + b * b;
    }
    const T l1 = m_sqrt(q1), l2 = m_sqrt(q2);
    const T c = m_abs(l1 - l2);
    T s = c < eps ? m_exp(T(-0.5) * c * c / s2) : T(0);
    if (mindist > T(0) && (l1 < mindist || l2 < mindist)) s = T(0);
    return s;
  }
};
"""

# PlanarCauchy's score, with the pair body's stages
CAUCHY_SOURCE = """
template <typename T>
struct Score {
  static constexpr int D = 2;
  using Value = T;
  static constexpr bool kExactScreen = sizeof(T) == 8;
  T s2, eps;
  float sk;  // screen_sq's bound for eps

  // p: (sigma^2, epsilon, unused, unused), formed in double
  __host__ __device__ Score(const double (&p)[4])
      : s2((T)p[0]), eps((T)p[1]), sk(screen_k(p[1])) {}

  // ((0 + dx^2) + dy^2), correctly rounded square root
  __device__ static T length(const T* a, const T* b) {
    const T dx = a[0] - b[0], dy = a[1] - b[1];
    return m_sqrt(T(0) + dx * dx + dy * dy);
  }
  // the squared length with its last step fused, for the f32 screen
  __device__ static float sq_fused(const float* a, const float* b) {
    const float dx = __fsub_rn(a[0], b[0]), dy = __fsub_rn(a[1], b[1]);
    return __fmaf_rn(dy, dy, __fmul_rn(dx, dx));
  }

  __device__ T operator()(const T* r1, const T* c1, const T* r2,
                          const T* c2) const {
    const T c = m_abs(length(r1, c1) - length(r2, c2));
    return c < eps ? T(1) / (T(1) + c * c / s2) : T(0);
  }
  __device__ bool screen(const T* r1, const T* c1, const T* r2,
                         const T* c2, T& v) const {
    if constexpr (kExactScreen)
      return gate(r1, c1, r2, c2, v);
    else
      return screen_sq(sq_fused(r1, c1), sq_fused(r2, c2), sk);
  }
  __device__ bool gate(const T* r1, const T* c1, const T* r2, const T* c2,
                       T& v) const {
    v = m_abs(length(r1, c1) - length(r2, c2));
    return v < eps;
  }
  __device__ T tail(const T*, const T*, const T*, const T*, T v) const {
    return T(1) / (T(1) + v * v / s2);
  }
};
"""


class UserEuclidean(PairwiseInvariant):
    """The built-in Euclidean invariant's score over ``d`` values a set,
    as a user's own device score (operator() alone)."""

    symmetric = True

    def __init__(self, params: EuclideanDistanceParams =
                 EuclideanDistanceParams(), d: int = 3):
        self.params, self.d = params, d
        self._plain = EuclideanDistance(params)

    def __call__(self, ai, aj, bi, bj):
        return self._plain(ai, aj, bi, bj)

    def score_matrix(self, P1, P2):
        return self._plain.score_matrix(P1, P2)

    def score_block(self, P1r, P1c, P2r, P2c):
        return self._plain.score_block(P1r, P1c, P2r, P2c)

    def cuda_score(self) -> DeviceScore:
        p = self.params
        return DeviceScore(EUCLID_SOURCE.replace("{d}", str(self.d)), self.d,
                           (p.sigma * p.sigma, p.epsilon, p.mindist))


@dataclasses.dataclass(frozen=True)
class PlanarCauchyParams:
    sigma: float = 0.015    # scale of the Cauchy kernel
    epsilon: float = 0.05   # consistency bound: inlier/outlier gate


def _planar_lengths(a, b):
    """||a - b|| of (..., 2) points, summed ((0 + dx^2) + dy^2)."""
    diff = a - b
    sq = torch.zeros(diff.shape[:-1], dtype=diff.dtype, device=diff.device)
    for k in range(diff.shape[-1]):
        sq = sq + diff[..., k] * diff[..., k]
    return torch.sqrt(sq)


class PlanarCauchy(PairwiseInvariant):
    """Planar points (d = 2): s = 1 / (1 + c^2 / sigma^2) where c = |l1 -
    l2| < epsilon, else 0, the lengths summed in coordinate order."""

    symmetric = True

    def __init__(self, params: PlanarCauchyParams = PlanarCauchyParams()):
        self.params = params

    def _score_from_lengths(self, l1, l2):
        p = self.params
        c = torch.abs(l1 - l2)
        # divide by tensors on c's device: PyTorch's CUDA division by a
        # Python scalar multiplies by its f32 reciprocal instead
        s2 = torch.full((), p.sigma * p.sigma, dtype=c.dtype, device=c.device)
        one = torch.ones((), dtype=c.dtype, device=c.device)
        return torch.where(c < p.epsilon, one / (one + c * c / s2), 0.0)

    def __call__(self, ai, aj, bi, bj):
        return self._score_from_lengths(_planar_lengths(ai, aj),
                                        _planar_lengths(bi, bj))

    def score_matrix(self, P1, P2):
        return self._score_from_lengths(pairwise_distance_matrix(P1),
                                        pairwise_distance_matrix(P2))

    def score_block(self, P1r, P1c, P2r, P2c):
        return self._score_from_lengths(cross_distance_matrix(P1r, P1c),
                                        cross_distance_matrix(P2r, P2c))

    def cuda_score(self) -> DeviceScore:
        p = self.params
        return DeviceScore(CAUCHY_SOURCE, 2, (p.sigma * p.sigma, p.epsilon))


__all__ = ["CAUCHY_SOURCE", "EUCLID_SOURCE", "PlanarCauchy",
           "PlanarCauchyParams", "UserEuclidean"]
