// The stacked [M; C] build kernel, int8 or bf16: the (2m, m) storage of
// W problems, rows 0..m-1 M and m..2m-1 C, both triangles. The stacked
// build (kernel 4) runs it with the built-in scores (stored_build.cu) and
// with an invariant's own device score (user_score.cuh, through
// stored_build_run in the library _kernels builds for it); the
// build-anatomy probe (build_probe.cu, kernel 10) runs it with its
// ablated scores and with NoScore, the write floor, so that the probe
// times this kernel and no other (its `full` is kernel 4 by
// construction).
//
//   int8: M = clip(rint(127 s), 0, 127) (round half to even, as
//         jnp.round), C = 127;
//   bf16: M = bf16(s) rounded to nearest even from the f32 score (the JAX
//         kernel keeps s in f32 and casts once), C = 1;
//   keep = distinct & off-diagonal & row, col < m_true[w] & s > affeps,
//   and M = C = 0 elsewhere.
//
// A score functor takes a row's and a column's endpoints in both sets,
// (r1, c1) and (r2, c2), each Score::D f32 values, and returns the score
// s; it must be symmetric bit for bit (score(b, a) = score(a, b)), as the
// built-in scores are (the coordinate differences of one order are the
// exact negations of the other's; x y and y x round alike), and so are
// the masks, so the output is symmetric and one evaluation serves both
// triangles.
//
// Design: each pair scored once. The grid enumerates the unordered pairs
// (I <= J) of 64 x 64 tiles of each problem, row-major, by a closed form
// of the block index (tile_pair; ops/affinity_pallas.stored_tile_pair
// mirrors it; the tiling, the staged codes and their write are
// staged_codes.cuh's, which the triangle and dense builds share). A block
// of 128 threads stages its row tile's and its column tile's endpoints in
// shared memory; each thread holds one column's endpoints in registers
// and scores 32 consecutive rows of it, four a step. It leaves each M
// code, with C's in its top bit, in shared memory twice: in place (row i,
// column j) and transposed (row j: a step's four values as one 4- or
// 8-byte store), then writes tile (I, J) and its transpose at (J, I),
// both halves, as 16-byte row chunks, consecutive threads on consecutive
// chunks (coalesced). A diagonal tile (I = J) scores its pairs in both
// orders (1/n of the work) and writes once. m need not divide by the
// tile: edge tiles check their bounds, and where m is not a multiple of a
// 16-byte chunk the rows are written element by element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "staged_codes.cuh"
#include "store_put.cuh"

namespace {

// The write floor of the build: no endpoint read, no pair scored, every
// staged code 0 (build_probe.cu's writeonly)
struct NoScore {
  static constexpr int D = 3;
};

template <typename Score, typename T>
__global__ void __launch_bounds__(kThreads) stored_build_kernel(
    const Score score, const float* __restrict__ P1,
    const float* __restrict__ P2, const int* __restrict__ A,
    const int* __restrict__ m_trues, T* __restrict__ out, int m, int n,
    float affeps, bool vec) {
  constexpr int D = Score::D;
  using St = Staged<T>;
  // staged codes: [0] in place, [1] transposed
  __shared__ __align__(16) uint8_t stage[2][St::kBytes];
  // endpoints of the row tile [0] and the column tile [1]
  __shared__ __align__(16) float e1[2][kTile * D];
  __shared__ __align__(16) float e2[2][kTile * D];
  __shared__ __align__(16) int ea[2][kTile * 2];

  const int2 ij = tile_pair(blockIdx.x, n);
  const int r0 = ij.x * kTile, c0 = ij.y * kTile;
  const bool diag = ij.x == ij.y;
  const int w = blockIdx.y;
  if constexpr (std::is_same_v<Score, NoScore>) {
    // the write floor: both staged tiles zero, nothing scored
    uint4* z = reinterpret_cast<uint4*>(stage[0]);
    for (int q = threadIdx.x; q < (diag ? 1 : 2) * St::kBytes / 16;
         q += kThreads)
      z[q] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    const int lim = m_trues[w];
    const float* p1 = P1 + (size_t)w * m * D;
    const float* p2 = P2 + (size_t)w * m * D;
    const int* a = A + (size_t)w * m * 2;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int base = t ? c0 : r0;
      const int rows = min(kTile, m - base);
      for (int q = threadIdx.x; q < rows * D; q += kThreads) {
        e1[t][q] = p1[(size_t)base * D + q];
        e2[t][q] = p2[(size_t)base * D + q];
      }
      for (int q = threadIdx.x; q < rows * 2; q += kThreads)
        ea[t][q] = a[(size_t)base * 2 + q];
    }
    __syncthreads();

    const int j = threadIdx.x % kTile;
    const int i0 = threadIdx.x / kTile * kRowsPer;
    const int gc = c0 + j;
    float c1[D], c2[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      c1[e] = e1[1][j * D + e];
      c2[e] = e2[1][j * D + e];
    }
    const int ca0 = ea[1][j * 2], ca1 = ea[1][j * 2 + 1];
    constexpr int kPerWord = 4 / (int)sizeof(T);
    // kStep rows at a time: a draft that unrolled all of a thread's rows
    // (sixteen, 256 threads a block) ran the point-normal build a third
    // slower on the H100
#pragma unroll 1
    for (int e0 = 0; e0 < kRowsPer; e0 += kStep) {
      uint32_t wm[St::kWords];  // the step's codes, packed
#pragma unroll
      for (int q = 0; q < St::kWords; ++q) wm[q] = 0u;
#pragma unroll
      for (int k = 0; k < kStep; ++k) {
        const int i = i0 + e0 + k, gr = r0 + i;
        float s = 0.f;
        bool keep = false;
        if (gr < m && gc < m) {
          s = score(e1[0] + i * D, c1, e2[0] + i * D, c2);
          const bool distinct =
              !(ea[0][i * 2] == ca0 || ea[0][i * 2 + 1] == ca1);
          keep = distinct && gr != gc && gr < lim && gc < lim && s > affeps;
        }
        T mv, cv;  // C's code travels as the flag
        put(&mv, &cv, keep, s);
        const uint32_t p = bits_of(mv) | (keep ? St::kFlag : 0u);
        T pv;
        from_bits(&pv, p);
        reinterpret_cast<T*>(stage[0] + i * St::kPitch)[j] = pv;
        const int sh = 8 * (int)sizeof(T) * (k % kPerWord);
        wm[k / kPerWord] |= p << sh;
      }
      if (!diag) {
        // row j of the transposed tile, columns i0 + e0 .. + kStep - 1
        const int at = j * St::kPitch + (i0 + e0) * (int)sizeof(T);
        if constexpr (St::kWords == 1)
          *reinterpret_cast<uint32_t*>(stage[1] + at) = wm[0];
        else
          *reinterpret_cast<uint2*>(stage[1] + at) = make_uint2(wm[0], wm[1]);
      }
    }
  }
  __syncthreads();

  T* M = out + (size_t)w * 2 * m * m;
  T* C = M + (size_t)m * m;
  const int rows = min(kTile, m - r0), cols = min(kTile, m - c0);
  const size_t at = (size_t)r0 * m + c0, at_t = (size_t)c0 * m + r0;
  write_staged<T>(stage[0], M + at, C + at, m, rows, cols, vec, threadIdx.x);
  if (!diag)
    write_staged<T>(stage[1], M + at_t, C + at_t, m, cols, rows, vec,
                    threadIdx.x);
}

// Launch the build of W problems of m associations into out (W, 2m, m)
// of T, 16-byte aligned.
template <typename T, typename Score>
int launch_stored(const Score& score, const void* P1, const void* P2,
                  const void* A, const void* m_trues, void* out, int W,
                  int m, float affeps, cudaStream_t stream) {
  const int n = (m + kTile - 1) / kTile;
  const long long pairs = (long long)n * (n + 1) / 2;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = m % Staged<T>::kChunk == 0;
  stored_build_kernel<Score, T><<<dim3((unsigned)pairs, W), kThreads, 0,
                                  stream>>>(
      score, (const float*)P1, (const float*)P2, (const int*)A,
      (const int*)m_trues, (T*)out, m, n, affeps, vec);
  return (int)cudaGetLastError();
}

// The build of W problems with the score Score(p), after the entries'
// argument checks (kernel 4's entries, stored_build.cu and a device
// score's library).
template <typename T, typename Score>
int stored_build_run(const double (&p)[4], const void* P1, const void* P2,
                     const void* A, const void* m_trues, void* out, int W,
                     int m, double affeps, cudaStream_t stream) {
  if (W < 1 || m < 1 || W > 65535) return (int)cudaErrorInvalidValue;
  return launch_stored<T>(Score(p), P1, P2, A, m_trues, out, W, m,
                          (float)affeps, stream);
}

}  // namespace
