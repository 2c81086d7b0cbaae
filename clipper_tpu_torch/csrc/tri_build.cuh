// Fused affinity build straight into flat upper-triangle int8 or bf16
// storage, for Hopper: the Euclidean and the point-normal invariants.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:build_tri_pallas
// (:463-564), which evaluated one upper t-tile of one problem a grid
// step: scores, masks and quantization, written as that tile's (2t, t)
// [M; C] column block at column k t of problem w's (2t, S) storage. The
// bytes are the same; the work is cut otherwise. Each block here takes
// one pair of 64-row sub-tiles of one problem (tri_pair_build.cuh, the
// body tri_build_fused.cu runs too, so the two write the same bytes).
//
// The JAX kernel traced any symmetric invariant's score_block_t; this one
// takes a score functor: the two built-in invariants' (euclid_score.cuh,
// (W, m, 3) endpoints; pointnormal_score.cuh, (W, m, 6)), which repeat
// the plain PyTorch arithmetic step by step under --fmad=false, entered
// by kind from tri_build.cu, or an invariant's own device score of any d
// <= kMaxUserD (user_score.cuh), entered from the library _kernels builds
// for that score at first use (its user_tri_build_* entries). Invariants
// without a device score build through the plain version on the CPU and
// raise on CUDA. expf and acosf may differ from XLA's by an ulp, which
// can move an M code by one at a rounding tie; the C half is exact.
//
// What bounds it on this card: the 671 MB of int8 output at W=512, m=1024
// (0.2 ms at 3.35 TB/s; bf16 storage doubles it) against ~30 f32
// operations on each of the 268 M distinct pairs (0.12 ms at 67 TFLOP/s):
// bytes on paper, and the point-normal score's ~56 operations and four
// transcendentals about even. In practice the unfused IEEE steps take
// more instruction slots than those counts say, so the pairs' arithmetic sets
// the time. The design takes out what the JAX kernel's grid spent on it:
// each distinct pair is scored once (a diagonal t-tile's sub-tile pairs
// I <= J only, the transpose written from the same codes); every pair
// pays only the cheap masks and a screen of the gate from the squared
// lengths (no square root), and the exact score (the gate's two
// correctly rounded square roots, then its transcendental tail where the
// gate passes) runs for the pairs the screen passes, handed out 32 at a
// time per warp (a prefix sum by shuffles, no atomics); the codes leave
// through shared memory as 16-byte chunks (tri_pair_build.cuh). What is
// left for every pair is the screen's two squared lengths and the masks.
//
// Tiles: one route for every t >= 1 that divides m. The body cuts a t-tile
// into ceil(t / 64) sub-tiles of 64 rows, whatever t is, and nothing else
// is sized by t.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_pair_build.cuh"

namespace {

template <typename Score, typename T>
__global__ void __launch_bounds__(kThreads) tri_build_kernel(
    const Score score, const float* __restrict__ P1,
    const float* __restrict__ P2, const int* __restrict__ A,
    const int* __restrict__ m_trues, T* __restrict__ out, int m, int t,
    int n, int q, long long S, float affeps, bool vec) {
  constexpr int D = Score::D;
  constexpr int R = Ends<Score>::kVals;
  __shared__ __align__(16) PairStage<T> st;
  // endpoint records of the row sub-tile [0] and the column sub-tile [1]
  __shared__ __align__(16) float ends[2][kTile * R];

  const SubPair p = sub_pair(blockIdx.x, n, q, t, m / t, S);
  const int w = blockIdx.y;
  const float* p1 = P1 + (size_t)w * m * D;
  const float* p2 = P2 + (size_t)w * m * D;
  const int* a = A + (size_t)w * m * 2;
  // one row a thread: the row sub-tile's by threads 0..63, the column
  // sub-tile's by 64..127
  const int half = threadIdx.x / kTile, tid = threadIdx.x % kTile;
  if (half == 0)
    stage_ends<Score>(p1, p2, a, p.gr0, p.rows, ends[0], tid, kTile);
  else if (!p.diag)
    stage_ends<Score>(p1, p2, a, p.gc0, p.cols, ends[1], tid, kTile);
  clear_stage(st, p.mirror, threadIdx.x);
  __syncthreads();
  T* M = out + (size_t)w * (size_t)(2 * t) * (size_t)S;
  build_sub_pair<false>(score, ends[0], ends[p.diag ? 0 : 1], p, m_trues[w],
                        affeps, M, M + (long long)t * S, S, vec, st,
                        threadIdx.x, 0);
}

// Build W problems into out (W, 2t, S) of T with the score Score(p),
// after the entries' argument checks.
template <typename T, typename Score>
int tri_build_run(const double (&p)[4], const void* P1, const void* P2,
                  const void* A, const void* m_trues, void* out, int W,
                  int m, int t, long long S, double affeps, void* stream) {
  if (t < 1 || m % t || W < 1 || W > 65535)
    return (int)cudaErrorInvalidValue;
  const int q = (t + kTile - 1) / kTile;
  const long long n = (long long)(m / t) * q;
  const long long pairs = n * (n + 1) / 2;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = t * sizeof(T) % 16 == 0;
  tri_build_kernel<Score, T><<<dim3((unsigned)pairs, W), kThreads, 0,
                               (cudaStream_t)stream>>>(
      Score(p), (const float*)P1, (const float*)P2, (const int*)A,
      (const int*)m_trues, (T*)out, m, t, (int)n, q, S, (float)affeps, vec);
  return (int)cudaGetLastError();
}

}  // namespace
