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
// where kept. The variants (template instantiations of one body):
//
//   full      two sqrt, c = |l1 - l2|, exp(((-0.5 c) c) / s2) gated on
//             c < eps: the production math, through EuclidScore<float>
//             (euclid_score.cuh), so its output equals kernel 4's
//             (stored_build.cu) byte for byte;
//   sqrt1     c2 = max((q1 + q2) - 2 sqrt(q1 q2), 0), exp(c2 k) with
//             k = -0.5 / s2, gated on c2 < eps^2;
//   noexp     sqrt1's gate, writing the quantized c2;
//   nosqrt    gated on (q1 - q2)^2 < eps^2, writing q1 - q2;
//   writeonly zero tiles on the same grid and store pattern: the floor.
//
// Only full's values mean anything; the others exist for their times. q1
// and q2 are the squared distances summed in coordinate order, as in
// ops/pairwise.py; built with --fmad=false, so the plain version
// (bench/build_probe.build_probe_plain) repeats every rounding.
//
// What bounds it on this card: at B=512, m=1024 the 1.07 GB of int8
// output, 0.32 ms at 3.35 TB/s, against ~30 f32 operations on each of the
// 537 M entries, 0.24 ms at 67 TFLOP/s: bytes. Design: the port's own
// stacked build (stored_build_body.cuh: one block per (256 columns, 64
// rows, problem), one step writing both halves), with the score functor
// swapped; not the TPU's (nT, nT, 2) grid with its C-scratch pass, nor its
// tile = min(1024, m) that needed m to divide by the tile: edge blocks
// check their bounds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "stored_build_body.cuh"

namespace {

// ((0 + dx^2) + dy^2) + dz^2: dist3 without its square root
__device__ __forceinline__ float sqdist3(const float* a, const float* b) {
  const float dx = rn_sub(a[0], b[0]);
  const float dy = rn_sub(a[1], b[1]);
  const float dz = rn_sub(a[2], b[2]);
  float sq = rn_mul(dx, dx);
  sq = rn_add(sq, rn_mul(dy, dy));
  return rn_add(sq, rn_mul(dz, dz));
}

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

// writeonly: both halves of the block's rows set to 0, one byte a thread
// a row, as the build body stores them
__global__ void __launch_bounds__(kCols) zero_kernel(int8_t* __restrict__ out,
                                                     int m) {
  const int c0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * kRows;
  const int w = blockIdx.z;
  const int rows = min(kRows, m - r0);
  const int gc = c0 + threadIdx.x;
  if (gc >= m) return;
  int8_t* ob = out + (size_t)w * 2 * m * m;
#pragma unroll 4
  for (int i = 0; i < rows; ++i) {
    const int gr = r0 + i;
    ob[(size_t)gr * m + gc] = 0;
    ob[(size_t)(m + gr) * m + gc] = 0;
  }
}

template <typename Score>
int launch(const Score& score, const void* P1, const void* P2, const void* A,
           const void* m_trues, void* out, int B, int m, float affeps,
           cudaStream_t stream) {
  stored_build_kernel<Score, int8_t>
      <<<stored_build_grid(B, m), kCols, 0, stream>>>(
          score, (const float*)P1, (const float*)P2, (const int*)A,
          (const int*)m_trues, (int8_t*)out, m, affeps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// variant: 0 full, 1 sqrt1, 2 noexp, 3 nosqrt, 4 writeonly (the order of
// bench/build_probe.VARIANTS). P1, P2 (B, m, 3) f32; A (B, m, 2) int32;
// m_trues (B,) int32 (m for every problem in the probe); out (B, 2m, m)
// int8. sigma, eps, affeps as the JAX probe's constants; the squares and
// the quotient are formed in double here, as the plain version forms them.
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
      return launch(EuclidScore<float>(p), P1, P2, A, m_trues, out, B, m, ae,
                    st);
    }
    case 1:
      return launch(Sqrt1Score{pp}, P1, P2, A, m_trues, out, B, m, ae, st);
    case 2:
      return launch(NoexpScore{pp}, P1, P2, A, m_trues, out, B, m, ae, st);
    case 3:
      return launch(NosqrtScore{pp}, P1, P2, A, m_trues, out, B, m, ae, st);
    case 4:
      zero_kernel<<<stored_build_grid(B, m), kCols, 0, st>>>((int8_t*)out,
                                                              m);
      return (int)cudaGetLastError();
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
