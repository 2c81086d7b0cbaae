// One upper tile of the flat-triangle [M; C] storage, built by one
// thread block: the body that tri_build.cu (one block per tile) and
// tri_build_fused.cu (one block per problem, looping over its tiles) both
// run, so that their outputs are identical by construction.
//
// Tile (r, c) of a problem covers rows r t .. r t + t - 1 and columns
// c t .. c t + t - 1; its (2t, t) [M; C] column block sits at column
// k t of the problem's (2t, S) storage (k its index in storage order).
// Numerics follow the JAX build step by step, because they decide the
// +-1 int8 codes and the 0/127 C codes: the score functor's value s
// (euclid_score.cuh, pointnormal_score.cuh), then
//   keep = distinct & off-diagonal & row, col < m_true & s > (float)affeps;
// then store_put.cuh's step for the storage type: int8 M = clip(rint(127
// s), 0, 127) (round half to even, as torch.round) and C = 127, or bf16
// M = bf16(s) and C = 1 (flattri.py:529-533 of the JAX package).
// The block's t row endpoints sit in shared memory; each thread holds one
// output column's endpoints in registers and walks the t rows, so each
// row of the tile is written as t consecutive elements by consecutive
// threads (coalesced).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "store_put.cuh"

constexpr int kMaxTile = 256;

// Shared staging of a tile's row endpoints, D values each.
template <int D>
struct TileRows {
  float r1[kMaxTile * D];
  float r2[kMaxTile * D];
  int ra[kMaxTile * 2];
};

// p1, p2: the problem's (m, D) endpoints; a: its (m, 2) associations;
// ob: its storage advanced to column k t. Every thread of the block calls
// it; the leading barrier lets a block reuse `rows` tile after tile.
template <typename Score, typename T>
__device__ __forceinline__ void build_tri_tile(
    const Score& score, const float* __restrict__ p1,
    const float* __restrict__ p2, const int* __restrict__ a, int lim, int r,
    int c, int t, long long S, float affeps, T* __restrict__ ob,
    TileRows<Score::D>& rows) {
  constexpr int D = Score::D;
  __syncthreads();
  for (int q = threadIdx.x; q < t * D; q += blockDim.x) {
    rows.r1[q] = p1[(size_t)r * t * D + q];
    rows.r2[q] = p2[(size_t)r * t * D + q];
  }
  for (int q = threadIdx.x; q < t * 2; q += blockDim.x)
    rows.ra[q] = a[(size_t)r * t * 2 + q];
  __syncthreads();

  for (int l = threadIdx.x; l < t; l += blockDim.x) {
    const int gc = c * t + l;
    float c1[D], c2[D];
#pragma unroll
    for (int e = 0; e < D; ++e) {
      c1[e] = p1[(size_t)gc * D + e];
      c2[e] = p2[(size_t)gc * D + e];
    }
    const int ca0 = a[(size_t)gc * 2], ca1 = a[(size_t)gc * 2 + 1];
    for (int i = 0; i < t; ++i) {
      const int gr = r * t + i;
      const float s = score(rows.r1 + i * D, c1, rows.r2 + i * D, c2);
      const bool distinct =
          !(rows.ra[i * 2] == ca0 || rows.ra[i * 2 + 1] == ca1);
      const bool keep = distinct && gr != gc && gr < lim && gc < lim &&
                        s > affeps;
      put(ob + (size_t)i * S + l, ob + (size_t)(t + i) * S + l, keep, s);
    }
  }
}
