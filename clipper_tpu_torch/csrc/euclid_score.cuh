// The Euclidean pairwise score, step for step as the plain PyTorch build
// computes it (invariants/euclidean.py, ops/pairwise.py), shared by the
// build kernels tri_build.cu, tri_build_fused.cu, stored_build.cu and
// affinity_build.cu, in float or double. They are compiled with
// --fmad=false, and the explicit round-to-nearest intrinsics keep FMA
// contraction from changing the roundings that decide the int8 codes:
//   sq = ((0 + dx^2) + dy^2) + dz^2 in coordinate order, l = sqrt(sq);
//   c = |l1 - l2|; s = exp(((-0.5 c) c) / s2), s2 = (T)(sigma sigma)
//   formed in double on the host; gated on c < (T)epsilon; 0 when
//   mindist > 0 and l1 or l2 < mindist.
// The (b, a) coordinate differences are the exact negations of the (a, b)
// ones, so the score of a pair does not depend on its order.
//
// A score functor takes a row's and a column's endpoints in both sets,
// (r1, c1) and (r2, c2), each D values, so that one build body serves
// every invariant: EuclidScore (D = 3) here, PointNormalScore (D = 6) in
// pointnormal_score.cuh, and an invariant's own score (any D up to
// user_score.cuh's kMaxUserD) through user_score.cuh's adaptor. A functor
// has static constexpr int D, using Value = T (float or double), a
// constructor from const double (&)[4] (its parameters, formed in double
// on the host), operator()(r1, c1, r2, c2) returning the score s >= +0
// (no -0, which would read as C's flag) and symmetric bit for bit (s(c, r)
// = s(r, c)), and, for the pair body (tri_pair_build.cuh), the stages
// screen / gate / tail below, kExactScreen and kTailAt (where the tail's
// values lie in a record: tri_pair_build.cuh's Ends).

#pragma once

__device__ __forceinline__ float rn_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double rn_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float rn_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double rn_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float rn_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double rn_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float rn_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double rn_div(double a, double b) {
  return __ddiv_rn(a, b);
}
// the CUDA math library's correctly rounded sqrt and its exp / acos, the
// functions PyTorch's CUDA kernels call for the same operators
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_acos(float x) { return acosf(x); }
__device__ __forceinline__ double m_acos(double x) { return acos(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }
// clamp(x, lo, hi) as torch.clamp: min(max(x, lo), hi)
__device__ __forceinline__ float m_clamp(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ double m_clamp(double x, double lo, double hi) {
  return fmin(fmax(x, lo), hi);
}

// ||a - b||^2 over 3 coordinates, summed in coordinate order
template <typename T>
__device__ __forceinline__ T sqdist3(const T* a, const T* b) {
  const T dx = rn_sub(a[0], b[0]);
  const T dy = rn_sub(a[1], b[1]);
  const T dz = rn_sub(a[2], b[2]);
  T sq = rn_mul(dx, dx);
  sq = rn_add(sq, rn_mul(dy, dy));
  return rn_add(sq, rn_mul(dz, dz));
}

// ||a - b||, correctly rounded from sqdist3
template <typename T>
__device__ __forceinline__ T dist3(const T* a, const T* b) {
  return m_sqrt(sqdist3(a, b));
}

// sqdist3 with the last two steps fused (two FMAs): within 2^-21 of
// sqdist3's value (no cancellation: all terms are squares), for
// screen_sq only
__device__ __forceinline__ float sqdist3_fused(const float* a,
                                               const float* b) {
  const float dx = __fsub_rn(a[0], b[0]);
  const float dy = __fsub_rn(a[1], b[1]);
  const float dz = __fsub_rn(a[2], b[2]);
  return __fmaf_rn(dz, dz, __fmaf_rn(dy, dy, __fmul_rn(dx, dx)));
}

// A screen of the gate |l1 - l2| < e of both scores, l = dist3 =
// sqrt(q) correctly rounded, from sqdist3_fused's q1, q2 (no square
// root): false only where the gate fails for certain. With s = q1 + q2
// and d = |q1 - q2| exact, |sqrt(q1) - sqrt(q2)| = d / (sqrt(q1) +
// sqrt(q2)) >= d / sqrt(2 s), and rounding moves each length by 2^-24 of
// itself, so |l1 - l2| >= e wherever d^2 >= (e sqrt(2 s) + 2^-23 s)^2.
// Here d is taken 2^-19 s low (sqdist3_fused's q are within 2^-21 of
// sqdist3's) and the bound as k s + 2^-34 s^2 with k = 2 e^2 (1 + 2^-9),
// which covers that square with room for the roundings. Zero, infinite
// or NaN lengths make it true: the exact gate decides. The bound is tight
// where the gate matters (l1 near l2, where d / sqrt(2 s) is nearly |l1 -
// l2|), so it passes little more than the gate does.
__device__ __forceinline__ bool screen_sq(float q1, float q2, float k) {
  const float s = __fadd_rn(q1, q2);
  const float d = __fmaf_rn(-0x1p-19f, s, fabsf(__fsub_rn(q1, q2)));
  const float thr = __fmaf_rn(k, s, __fmul_rn(__fmul_rn(s, s), 0x1p-34f));
  return !((d > 0.f) & (__fmul_rn(d, d) > thr));  // &: no branch
}

// screen_sq's k for the f32 bound e of a gate
__host__ __device__ inline float screen_k(double bound) {
  const double e = (double)(float)bound;
  return (float)(2.0 * e * e * (1.0 + 1.0 / 512.0));
}

// exp(((-0.5 d) d) / s2)
template <typename T>
__device__ __forceinline__ T gauss(T d, T s2) {
  return m_exp(rn_div(rn_mul(rn_mul((T)-0.5, d), d), s2));
}

template <typename T>
struct EuclidScore {
  static constexpr int D = 3;
  using Value = T;
  T s2, eps, mindist;
  float sk;  // screen_sq's k for eps

  // p: (s2, epsilon, mindist, unused), formed in double on the host
  __host__ __device__ EuclidScore(const double (&p)[4])
      : s2((T)p[0]), eps((T)p[1]), mindist((T)p[2]),
        sk(screen_k(p[1])) {}

  __device__ __forceinline__ T operator()(const T* r1, const T* c1,
                                          const T* r2, const T* c2) const {
    const T l1 = dist3(r1, c1);
    const T l2 = dist3(r2, c2);
    const T cc = m_abs(rn_sub(l1, l2));
    T s = (T)0;
    if (cc < eps) s = gauss(cc, s2);
    if (mindist > (T)0 && (l1 < mindist || l2 < mindist)) s = (T)0;
    return s;
  }

  // operator() in stages, for builds that run the exact score only
  // where it can be non-zero (tri_pair_build.cuh), on points and normals
  // apart (3 values each): screen() takes the pair's points and is false
  // only where gate() fails for certain: in f32 screen_sq of the two
  // squared lengths (sqdist3_fused, no square root), v untouched; in f64
  // gate() itself, v getting gate()'s v (screen_sq's margin is derived
  // for f32 lengths), so that a pair it passes needs no second gate
  // (kExactScreen); gate() is the score's first part, the two lengths
  // and c, and is false where the score is 0 whatever follows (c >= eps,
  // or a length under mindist), v getting c; tail() is the rest for a
  // pair that passed with v (Euclidean: no normals). Where gate()
  // passes, tail() returns operator()'s value bit for bit; where it
  // fails, operator() returns 0.
  static constexpr bool kExactScreen = sizeof(T) == 8;
  static constexpr int kTailAt = 0;  // the tail reads v alone
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
    return v < eps && !(mindist > (T)0 && (l1 < mindist || l2 < mindist));
  }
  __device__ __forceinline__ T tail(const T*, const T*, const T*, const T*,
                                    T v) const {
    return gauss(v, s2);
  }
};
