// Dense affinity build of one problem: (m, m) M and its 0/1 pattern C in
// the working precision (f32 or f64), for Hopper: the Euclidean and the
// point-normal invariants.
//
// Replaces the TPU kernel clipper_tpu/ops/affinity_pallas.py:
// build_affinity_pallas (:42-104). Like it, it scores the (row, column)
// pairs from the gathered (m, D) endpoints and writes
//   keep = distinct & off-diagonal & s > (T)affeps;
//   M = keep ? s : 0 (so a zero diagonal), C = keep ? 1 : 0,
// the function ops.affinity.pairwise_from_endpoints computes (the
// reference's src/clipper.cpp:21-65). The JAX kernel padded m to its
// tile; here the edge tiles check their bounds, for any m.
//
// The score is a functor of euclid_score.cuh (D = 3) or
// pointnormal_score.cuh (D = 6) in T = float or double, built with
// --fmad=false: the plain version's IEEE steps in the same order, so M
// equals it bit for bit where the CUDA math library's exp, acos and sqrt
// are the functions PyTorch's CUDA kernels call; C is exact.
//
// What bounds it on this card: the output write, 8 bytes an entry in f32
// (200 MB at m=5000: 0.06 ms at 3.35 TB/s) and 16 in f64, against ~56
// operations on each of the m (m - 1) / 2 distinct pairs for the
// point-normal score, four of them transcendentals (0.7 GFLOP at m=5000:
// 0.01 ms at 67 TFLOP/s in f32) — bytes, for either invariant. At m=1024
// (8 MB in f32) it is latency: one wave of blocks has to fill the card.
//
// Design: the body of the triangle builds (tri_pair_build.cuh, kernels 2
// and 8) over a third address map, two dense (m, m) arrays. One block
// takes one unordered pair (I <= J) of 64 x 64 tiles (staged_codes.cuh's
// tile_pair: n (n + 1) / 2 blocks for n = ceil(m / 64), 136 at m=1024),
// so each distinct pair is scored once: tile (I, J) is written
// in place and at (J, I) from the same staged values, and a diagonal tile
// scores i < j only and writes both orders (the score and the masks are
// symmetric bit for bit). A first pass applies the masks and the
// functor's screen to every pair and keeps a bit a row; a second pass
// hands the marked pairs out 32 a warp for the exact gate and, where it
// passes, the tail, which returns operator()'s value bit for bit. In f32
// the screen is screen_sq's square-root-free bound; in f64 it is the
// exact f64 gate itself, once a pair (screen_sq's margins are derived for
// f32 lengths and the f32 bound, and the f64 gate is held exactly
// instead), and the gate's value waits in the pair's stage cell, so the
// second pass runs the tail alone. The transcendental tail runs only
// where the gate passes in both. M's value carries C's flag in its sign
// bit (M >= 0) through shared memory, and both leave as 16-byte chunks,
// consecutive threads on consecutive chunks; where a row is not 16-byte
// aligned (m % 4 != 0 in f32, m odd in f64) they go value by value. The
// staged tile in place and transposed is 68 KB in f64, above the static
// 48 KB, so the block's shared memory is dynamic. A block is 512 threads, each one
// column and 8 rows, where kernels 2 and 8 take 128 threads and 32 rows
// a pair of tiles: at m=1024 the 136 blocks would hold 4 warps an SM, and
// one serial thread's 32 rows set the time (built with kUnit = 128 it
// took 0.0213 against 0.0118 ms f32 bunny m=1024, 0.1020 against 0.0831
// point-normal m=5000 on an H100 80GB HBM3 at 700 W).
//
// Route: the shared body, not a kernel of its own on stored_build.cu's
// walk. What tied the body to f32, its endpoint records (Ends,
// stage_ends) and its score values, is templated on the value type, and
// its largest-tile limit (kMaxTile) belongs to the flat map alone, so the
// third map costs nothing a kernel of its own would save; kernels 2, 6
// and 8 share one first pass, one queue and one write.

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"
#include "tri_pair_build.cuh"

namespace {

constexpr int kUnit = 512;  // threads of a block: one column, 8 rows each

// Where tile pair k (I <= J) of the n x n tiles of 64 goes in the dense
// (m, m) M and C (ops/affinity_pallas.dense_tile_pair mirrors it).
__device__ __forceinline__ SubPair dense_pair(int k, int n, int m) {
  const int2 ij = tile_pair(k, n);
  SubPair p;
  p.gr0 = ij.x * kTile;
  p.gc0 = ij.y * kTile;
  p.rows = min(kTile, m - p.gr0);
  p.cols = min(kTile, m - p.gc0);
  p.diag = ij.x == ij.y;
  p.mirror = !p.diag;
  p.at = (long long)p.gr0 * m + p.gc0;
  p.at_t = (long long)p.gc0 * m + p.gr0;
  return p;
}

// a block's shared memory: the staged values, then the endpoint records
// of its row tile and its column tile
template <int D, typename T>
constexpr size_t dense_smem() {
  return sizeof(PairStage<T>) + 2 * kTile * Ends<D>::kVals * sizeof(T);
}

template <typename Score, typename T>
__global__ void __launch_bounds__(kUnit) affinity_build_kernel(
    const Score score, const T* __restrict__ P1, const T* __restrict__ P2,
    const int* __restrict__ A, T* __restrict__ M, T* __restrict__ C, int m,
    int n, T affeps, bool vec) {
  constexpr int D = Score::D;
  constexpr int R = Ends<D>::kVals;
  extern __shared__ __align__(16) uint8_t smem[];
  PairStage<T>& st = *reinterpret_cast<PairStage<T>*>(smem);
  T* ends = reinterpret_cast<T*>(smem + sizeof(PairStage<T>));

  const SubPair p = dense_pair(blockIdx.x, n, m);
  // one row a thread: the row tile's by threads 0..63, the column tile's
  // by 64..127
  const int half = threadIdx.x / kTile, tid = threadIdx.x % kTile;
  if (half == 0)
    stage_ends<D>(P1, P2, A, p.gr0, p.rows, ends, tid, kTile);
  else if (half == 1 && !p.diag)
    stage_ends<D>(P1, P2, A, p.gc0, p.cols, ends + kTile * R, tid, kTile);
  clear_stage(st, p.mirror, threadIdx.x, kUnit);
  __syncthreads();
  build_sub_pair<false, Score, T, kUnit>(
      score, ends, ends + (p.diag ? 0 : kTile * R), p, m, affeps, M, C, m,
      vec, st, threadIdx.x, 0);
}

template <typename T, template <typename> class Score>
int launch(const double (&p)[4], const void* P1, const void* P2,
           const void* A, void* M, void* C, int m, double affeps,
           void* stream) {
  using S = Score<T>;
  const int n = (m + kTile - 1) / kTile;
  const long long pairs = (long long)n * (n + 1) / 2;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = dense_smem<S::D, T>();
  if constexpr (smem > 48 * 1024) {
    // once an instantiation and device, off the latency-bound launch path
    static bool set[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !set[dev]) {
      e = cudaFuncSetAttribute(affinity_build_kernel<S, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) set[dev] = true;
    }
  }
  const bool vec = m % Staged<T>::kChunk == 0 &&
                   ((uintptr_t)M | (uintptr_t)C) % 16 == 0;
  affinity_build_kernel<S, T>
      <<<(unsigned)pairs, kUnit, smem, (cudaStream_t)stream>>>(
          S(p), (const T*)P1, (const T*)P2, (const int*)A, (T*)M, (T*)C, m,
          n, (T)affeps, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* P1, const void* P2, const void* A, void* M,
             void* C, int m, int kind, double p0, double p1, double p2,
             double p3, double affeps, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return launch<T, EuclidScore>(p, P1, P2, A, M, C, m, affeps, stream);
  if (kind == 1)
    return launch<T, PointNormalScore>(p, P1, P2, A, M, C, m, affeps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// P1, P2 (m, D) in T with D = 3 (kind 0, Euclidean) or 6 (kind 1,
// point-normal); A (m, 2) int32; M, C (m, m) in T. p0..p3: the score's
// parameters (invariants.kernel_score).
int affinity_build_f32(const void* P1, const void* P2, const void* A,
                       void* M, void* C, int m, int kind, double p0,
                       double p1, double p2, double p3, double affeps,
                       void* stream) {
  return dispatch<float>(P1, P2, A, M, C, m, kind, p0, p1, p2, p3, affeps,
                         stream);
}

int affinity_build_f64(const void* P1, const void* P2, const void* A,
                       void* M, void* C, int m, int kind, double p0,
                       double p1, double p2, double p3, double affeps,
                       void* stream) {
  return dispatch<double>(P1, P2, A, M, C, m, kind, p0, p1, p2, p3, affeps,
                          stream);
}

}  // extern "C"
