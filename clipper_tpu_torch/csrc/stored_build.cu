// Fused affinity build straight into dense stacked [M; C] storage, int8
// or bf16, for Hopper: the Euclidean and the point-normal invariants.
//
// Replaces the TPU kernel clipper_tpu/ops/affinity_pallas.py:
// score_consistency_stored_pallas (:107-242). Like it, it evaluates the
// score, the masks and the quantization of every (row, column) pair of
// each problem and writes the (2m, m) storage of problem w: rows 0..m-1
// hold M, rows m..2m-1 hold C, both triangles.
//
//   int8: M = clip(rint(127 s), 0, 127) (round half to even, as
//         jnp.round), C = 127;
//   bf16: M = bf16(s) rounded to nearest even from the f32 score (the JAX
//         kernel keeps s in f32 and casts once), C = 1;
//   keep = distinct & off-diagonal & row, col < m_true[w] & s > affeps,
//   and M = C = 0 elsewhere.
//
// The score is a functor of euclid_score.cuh ((W, m, 3) endpoints) or
// pointnormal_score.cuh ((W, m, 6)), the arithmetic of tri_build.cu,
// built with --fmad=false as well: its int8 codes equal the plain
// build's. The score of (b, a) equals that of (a, b) bit for bit, so the
// output equals its transpose. Other invariants raise on CUDA, as for
// tri_build.cu.
//
// What bounds it on this card: at W=512, m=1024 the 1.07 GB of int8
// output (0.32 ms at 3.35 TB/s) against ~30 f32 operations on each of the
// 537 M entries (0.24 ms at 67 TFLOP/s): bytes (the point-normal score's
// ~60 operations and four transcendentals: operations). Design, the
// simple one of tri_build.cu: one block per (column tile, row tile,
// problem), its body in stored_build_body.cuh (shared with the ablations
// of build_probe.cu). m need not divide by a tile: the edge tiles check
// their bounds instead of the TPU kernel's padding. Every pair
// is computed twice, once for each triangle; computing it once and writing
// the tile and its transpose is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"
#include "stored_build_body.cuh"

namespace {

template <typename T, typename Score>
int launch(const Score& score, const void* P1, const void* P2, const void* A,
           const void* m_trues, void* out, int W, int m, float affeps,
           void* stream) {
  stored_build_kernel<Score, T><<<stored_build_grid(W, m), kCols, 0,
                                  (cudaStream_t)stream>>>(
      score, (const float*)P1, (const float*)P2, (const int*)A,
      (const int*)m_trues, (T*)out, m, affeps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* P1, const void* P2, const void* A,
             const void* m_trues, void* out, int W, int m, int kind,
             double p0, double p1, double p2, double p3, double affeps,
             void* stream) {
  if (W < 1 || m < 1 || W > 65535) return (int)cudaErrorInvalidValue;
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return launch<T>(EuclidScore<float>(p), P1, P2, A, m_trues, out, W, m,
                     (float)affeps, stream);
  if (kind == 1)
    return launch<T>(PointNormalScore<float>(p), P1, P2, A, m_trues, out, W,
                     m, (float)affeps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// P1, P2 (W, m, D) f32 with D = 3 (kind 0, Euclidean) or 6 (kind 1,
// point-normal); A (W, m, 2) int32; m_trues (W,) int32; out (W, 2m, m)
// int8 or bf16. p0..p3: the score's parameters (invariants.kernel_score).
int stored_build_int8(const void* P1, const void* P2, const void* A,
                      const void* m_trues, void* out, int W, int m, int kind,
                      double p0, double p1, double p2, double p3,
                      double affeps, void* stream) {
  return dispatch<int8_t>(P1, P2, A, m_trues, out, W, m, kind, p0, p1, p2,
                          p3, affeps, stream);
}

int stored_build_bf16(const void* P1, const void* P2, const void* A,
                      const void* m_trues, void* out, int W, int m, int kind,
                      double p0, double p1, double p2, double p3,
                      double affeps, void* stream) {
  return dispatch<__nv_bfloat16>(P1, P2, A, m_trues, out, W, m, kind, p0, p1,
                                 p2, p3, affeps, stream);
}

}  // extern "C"
