// The build-anatomy probe: five ablations of the stacked int8 [M; C]
// Euclidean build, timed side by side to attribute the build's time on
// this card to its write floor, its gates, its square roots and its exp.
//
// Replaces the TPU kernel clipper_tpu/bench/build_probe.py:
// main.make_builder (kernel body :53-121, pl.pallas_call :135-145). Like
// it, it writes the stacked (B, 2m, m) int8 [M; C] of B problems from
// their gathered endpoints P1, P2 (B, m, 3) f32 and associations A
// (B, m, 2) int32, with the masks of :100-115 (distinct, off-diagonal,
// inside m, score > affeps), M = clip(rint(127 s), 0, 127) and C = 127
// where kept. The variants, each the stacked build's kernel
// (stored_pair_build.cuh, the kernel of kernel 4) with its score functor
// swapped:
//
//   full      two sqrt, c = |l1 - l2|, exp(((-0.5 c) c) / s2) gated on
//             c < eps: the production math, EuclidScore<float>
//             (euclid_score.cuh), so this is kernel 4 (stored_build.cu)
//             itself, byte for byte and launch for launch;
//   sqrt1     c2 = max((q1 + q2) - 2 sqrt(q1 q2), 0), exp(c2 k) with
//             k = -0.5 / s2, gated on c2 < eps^2;
//   noexp     sqrt1's gate, writing the quantized c2;
//   nosqrt    gated on (q1 - q2)^2 < eps^2, writing q1 - q2;
//   writeonly NoScore: zero tiles through the same grid, staging and
//             16-byte stores, no endpoint read: kernel 4's write floor.
//
// Only full's values mean anything; the others exist for their times. q1
// and q2 are the squared distances summed in coordinate order, as in
// ops/pairwise.py; built with --fmad=false, so the plain version
// (bench/build_probe.build_probe_plain) repeats every rounding. Each
// score is symmetric in (i, j) bit for bit (q1 and q2 are), so one
// evaluation serves both triangles, as the kernel needs.
//
// What bounds it on this card: at B=512, m=1024 the 1.07 GB of int8
// output, 0.32 ms at 3.35 TB/s, against ~30 f32 operations on each of the
// 268 M distinct pairs, 0.12 ms at 67 TFLOP/s: bytes. Design: kernel 4's
// (stored_pair_build.cuh: one block per unordered pair of 64 x 64 tiles,
// each pair scored once, the tile and its transpose written as 16-byte
// chunks); not the TPU's (nT, nT, 2) grid with its C-scratch pass, nor
// its tile = min(1024, m) that needed m to divide by the tile: edge tiles
// check their bounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "stored_pair_build.cuh"

namespace {

// c2 = max((q1 + q2) - 2 sqrt(q1 q2), 0): one sqrt where full takes two
__device__ __forceinline__ float one_sqrt_c2(float q1, float q2) {
  const float r = m_sqrt(rn_mul(q1, q2));
  return fmaxf(rn_sub(rn_add(q1, q2), rn_mul(2.f, r)), 0.f);
}

struct ProbeParams {
  float eps2;  // (float)(eps * eps), eps * eps formed in double
  float k;     // (float)(-0.5 / (sigma * sigma)), formed in double
};

struct Sqrt1Score {
  static constexpr int D = 3;
  ProbeParams p;
  __device__ __forceinline__ float operator()(const float* r1,
                                              const float* c1,
                                              const float* r2,
                                              const float* c2) const {
    const float csq = one_sqrt_c2(sqdist3(r1, c1), sqdist3(r2, c2));
    return csq < p.eps2 ? m_exp(rn_mul(csq, p.k)) : 0.f;
  }
};

struct NoexpScore {
  static constexpr int D = 3;
  ProbeParams p;
  __device__ __forceinline__ float operator()(const float* r1,
                                              const float* c1,
                                              const float* r2,
                                              const float* c2) const {
    const float csq = one_sqrt_c2(sqdist3(r1, c1), sqdist3(r2, c2));
    return csq < p.eps2 ? csq : 0.f;
  }
};

struct NosqrtScore {
  static constexpr int D = 3;
  ProbeParams p;
  __device__ __forceinline__ float operator()(const float* r1,
                                              const float* c1,
                                              const float* r2,
                                              const float* c2) const {
    const float dq = rn_sub(sqdist3(r1, c1), sqdist3(r2, c2));
    return rn_mul(dq, dq) < p.eps2 ? dq : 0.f;
  }
};

}  // namespace

extern "C" {

// variant: 0 full, 1 sqrt1, 2 noexp, 3 nosqrt, 4 writeonly (the order of
// bench/build_probe.VARIANTS). P1, P2 (B, m, 3) f32; A (B, m, 2) int32;
// m_trues (B,) int32 (m for every problem in the probe); out (B, 2m, m)
// int8, 16-byte aligned. sigma, eps, affeps as the JAX probe's constants;
// the squares and the quotient are formed in double here, as the plain
// version forms them.
int build_probe_int8(int variant, const void* P1, const void* P2,
                     const void* A, const void* m_trues, void* out, int B,
                     int m, double sigma, double eps, double affeps,
                     void* stream) {
  if (B < 1 || m < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float ae = (float)affeps;
  const ProbeParams pp{(float)(eps * eps), (float)(-0.5 / (sigma * sigma))};
  switch (variant) {
    case 0: {
      const double p[4] = {sigma * sigma, eps, 0.0, 0.0};
      return launch_stored<int8_t>(EuclidScore<float>(p), P1, P2, A,
                                   m_trues, out, B, m, ae, st);
    }
    case 1:
      return launch_stored<int8_t>(Sqrt1Score{pp}, P1, P2, A, m_trues, out,
                                   B, m, ae, st);
    case 2:
      return launch_stored<int8_t>(NoexpScore{pp}, P1, P2, A, m_trues, out,
                                   B, m, ae, st);
    case 3:
      return launch_stored<int8_t>(NosqrtScore{pp}, P1, P2, A, m_trues, out,
                                   B, m, ae, st);
    case 4:
      return launch_stored<int8_t>(NoScore{}, P1, P2, A, m_trues, out, B, m,
                                   ae, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
