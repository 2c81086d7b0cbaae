// The Euclidean pairwise score, step for step as the plain PyTorch build
// computes it (invariants/euclidean.py, ops/pairwise.py), shared by the
// build kernels tri_build.cu and stored_build.cu. Both are compiled with
// --fmad=false, and the explicit __f*_rn intrinsics keep FMA contraction
// from changing the roundings that decide the int8 codes:
//   sq = ((0 + dx^2) + dy^2) + dz^2 in coordinate order, l = sqrtf(sq);
//   c = |l1 - l2|; s = expf(((-0.5 c) c) / s2), s2 = (float)(sigma sigma)
//   formed in double on the host; gated on c < (float)epsilon; 0 when
//   mindist > 0 and l1 or l2 < mindist.
// The (b, a) coordinate differences are the exact negations of the (a, b)
// ones, so the score of a pair does not depend on its order.

#pragma once

__device__ __forceinline__ float dist3(float ax, float ay, float az, float bx,
                                       float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  float sq = __fmul_rn(dx, dx);
  sq = __fadd_rn(sq, __fmul_rn(dy, dy));
  sq = __fadd_rn(sq, __fmul_rn(dz, dz));
  return sqrtf(sq);
}

__device__ __forceinline__ float euclid_score(float l1, float l2, float s2,
                                              float eps, float mindist) {
  const float cc = fabsf(__fsub_rn(l1, l2));
  float s = 0.f;
  if (cc < eps) s = expf(__fdiv_rn(__fmul_rn(__fmul_rn(-0.5f, cc), cc), s2));
  if (mindist > 0.f && (l1 < mindist || l2 < mindist)) s = 0.f;
  return s;
}
