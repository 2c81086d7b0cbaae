// Fused affinity build straight into dense stacked [M; C] storage, int8
// or bf16, for Hopper: the Euclidean and the point-normal invariants.
//
// Replaces the TPU kernel clipper_tpu/ops/affinity_pallas.py:
// score_consistency_stored_pallas (:107-242). Like it, it evaluates the
// score, the masks and the quantization of every pair of each problem and
// writes the (2m, m) storage of problem w: rows 0..m-1 hold M, rows
// m..2m-1 hold C, both triangles.
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
// build's. Other invariants raise on CUDA, as for tri_build.cu.
//
// What bounds it on this card: at W=512, m=1024 the 1.07 GB of int8
// output (0.32 ms at 3.35 TB/s) against ~30 f32 operations on each of the
// 268 M distinct pairs (0.12 ms at 67 TFLOP/s): bytes on paper (the
// point-normal score's ~56 operations and four transcendentals: still
// bytes). In practice the unfused IEEE mul/add chain, the correctly
// rounded division and sqrt and the library exp / acos take more issue
// slots than those counts say, and the pairs' arithmetic, not the
// writes, set the time (build_probe.cu measures the split).
//
// Design: each pair scored once, the kernel of stored_pair_build.cuh
// (one block per unordered pair of 64 x 64 tiles of a problem, the tile
// and its transpose written from the same staged codes as 16-byte
// chunks), which the build-anatomy probe (build_probe.cu, kernel 10)
// also runs with its ablated scores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"
#include "stored_pair_build.cuh"

namespace {

template <typename T>
int dispatch(const void* P1, const void* P2, const void* A,
             const void* m_trues, void* out, int W, int m, int kind,
             double p0, double p1, double p2, double p3, double affeps,
             void* stream) {
  if (W < 1 || m < 1 || W > 65535) return (int)cudaErrorInvalidValue;
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return launch_stored<T>(EuclidScore<float>(p), P1, P2, A, m_trues, out,
                            W, m, (float)affeps, (cudaStream_t)stream);
  if (kind == 1)
    return launch_stored<T>(PointNormalScore<float>(p), P1, P2, A, m_trues,
                            out, W, m, (float)affeps, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// P1, P2 (W, m, D) f32 with D = 3 (kind 0, Euclidean) or 6 (kind 1,
// point-normal); A (W, m, 2) int32; m_trues (W,) int32; out (W, 2m, m)
// int8 or bf16, 16-byte aligned. p0..p3: the score's parameters
// (invariants.kernel_score).
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
