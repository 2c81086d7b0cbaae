// The point-normal pairwise score (invariants/pointnormal.py), step for
// step as the plain PyTorch build computes it, for the build kernels:
//   l = sqrt of the unrolled squared distance of the points (dist3);
//   a = acos(clamp(dot, -1, 1)), dot = ((0 + x0 y0) + x1 y1) + x2 y2 of
//       the normals in coordinate order (ops/pairwise.cross_inner_matrix);
//   dp = |l1 - l2|, dn = |a1 - a2|;
//   s = exp(((-0.5 dp) dp) / sp2) * exp(((-0.5 dn) dn) / sn2), with
//       sp2 = sigp^2 and sn2 = sign^2 formed in double on the host;
//   s kept where dp < (T)epsp and dn < (T)epsn (strict), else 0.
// Built with --fmad=false like the Euclidean score. x y and y x round
// alike, so the score of a pair does not depend on its order.

#pragma once

#include "euclid_score.cuh"

template <typename T>
__device__ __forceinline__ T angle3(const T* a, const T* b) {
  T dot = rn_mul(a[0], b[0]);
  dot = rn_add(dot, rn_mul(a[1], b[1]));
  dot = rn_add(dot, rn_mul(a[2], b[2]));
  return m_acos(m_clamp(dot, (T)-1, (T)1));
}

template <typename T>
struct PointNormalScore {
  static constexpr int D = 6;
  using Value = T;
  T sp2, epsp, sn2, epsn;
  float sk;  // screen_sq's k for epsp

  // p: (sigp^2, epsp, sign^2, epsn), formed in double on the host
  __host__ __device__ PointNormalScore(const double (&p)[4])
      : sp2((T)p[0]), epsp((T)p[1]), sn2((T)p[2]), epsn((T)p[3]),
        sk(screen_k(p[1])) {}

  __device__ __forceinline__ T operator()(const T* r1, const T* c1,
                                          const T* r2, const T* c2) const {
    const T l1 = dist3(r1, c1);
    const T l2 = dist3(r2, c2);
    const T a1 = angle3(r1 + 3, c1 + 3);
    const T a2 = angle3(r2 + 3, c2 + 3);
    const T dp = m_abs(rn_sub(l1, l2));
    const T dn = m_abs(rn_sub(a1, a2));
    const T s = rn_mul(gauss(dp, sp2), gauss(dn, sn2));
    return (dp < epsp && dn < epsn) ? s : (T)0;
  }

  // operator() in stages (see EuclidScore::screen): the screen and the gate
  // take the two point distances and dp < epsp (v gets dp); the tail the
  // normals' two angles, dn < epsn and the product of the two gaussians,
  // which it forms only where dn < epsn (elsewhere operator() selects 0
  // too).
  static constexpr bool kExactScreen = sizeof(T) == 8;
  __device__ __forceinline__ bool screen(const T* r1, const T* c1,
                                         const T* r2, const T* c2,
                                         T& v) const {
    if constexpr (kExactScreen)
      return gate(r1, c1, r2, c2, v);
    else
      return screen_sq(sqdist3_fused(r1, c1), sqdist3_fused(r2, c2), sk);
  }
  __device__ __forceinline__ bool gate(const T* r1, const T* c1,
                                       const T* r2, const T* c2,
                                       T& v) const {
    const T l1 = dist3(r1, c1);
    const T l2 = dist3(r2, c2);
    v = m_abs(rn_sub(l1, l2));
    return v < epsp;
  }
  __device__ __forceinline__ T tail(const T* n1r, const T* n1c,
                                    const T* n2r, const T* n2c,
                                    T dp) const {
    const T a1 = angle3(n1r, n1c);
    const T a2 = angle3(n2r, n2c);
    const T dn = m_abs(rn_sub(a1, a2));
    return dn < epsn ? rn_mul(gauss(dp, sp2), gauss(dn, sn2)) : (T)0;
  }
};
