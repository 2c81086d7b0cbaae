// Flat upper-triangle int8 or bf16 [M; C] build with one thread block per
// problem, for Hopper.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:build_tri_pallas_fused
// (:567-655), whose grid had one program per problem that computed all T
// upper tiles of its problem in one unrolled loop (the TPU's per-program
// cost made the per-tile grid of build_tri_pallas expensive). Here block
// w builds problem w by the body tri_build.cuh runs (tri_pair_build.cuh):
// the two kernels write the same bytes, for both built-in invariants
// (entered by kind from tri_build_fused.cu) and for an invariant's own
// device score (user_score.cuh; the user_tri_build_fused_* entries of the
// library _kernels builds for it).
//
// What bounds it on this card: the same work as tri_build.cu (the int8
// output, 671 MB at W=512, m=1024: 0.2 ms at 3.35 TB/s, against the pairs'
// arithmetic, which sets the time). The design keeps tri_build.cu's cuts
// (each distinct pair scored once, the exact score only where the
// screen passes, 16-byte writes, here marked to be evicted first, which
// in bf16 measured faster with 132 problems written at once) and makes
// one block a problem fill an SM:
// kUnits units of 128 threads (32 warps) walk the problem's sub-tile
// pairs, each on its own named barrier and stage, unit u taking pair u
// first and then the next pair no unit has claimed (an integer counter in
// shared memory: which unit scores a pair does not change its bytes, and
// the pairs' costs differ). The problem's endpoints are read from device
// memory once, into dynamic shared memory (tri_pair_build.cuh's records,
// 32 or 64 bytes a row: 64 KB at point-normal m=1024), where they fit
// beside the units' stages; where they do not, each unit stages the two
// sub-tiles of each pair it takes, as tri_build.cu does
// (tri_build_fused_whole says which, from the record's bytes). That
// branch sets the widest record a score may have: in bf16 its 8 units'
// stages (147 KB) and 16 sub-tiles of 80-byte records (d = 9,
// user_score.cuh's kMaxUserD) fill the 227 KB a block may take. At
// W=512, one block an SM runs in 4 waves of 132. No pipeline selects it (the JAX package found it a wash
// against the per-tile grid).
//
// Tiles: one route for every t >= 1 that divides m. The body cuts a t-tile
// into ceil(t / 64) sub-tiles of 64 rows, whatever t is, and nothing else
// is sized by t.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_pair_build.cuh"

namespace {

constexpr int kUnits = 8;  // units of kThreads threads a block

// dynamic shared memory of a block: the units' stages, then the
// endpoint records of rec bytes, whole (kWhole: m records and kTile more,
// so that a sub-tile at the end has kTile readable ones) or a row and a
// column sub-tile a unit
template <typename T>
size_t fused_smem(int m, bool whole, size_t rec) {
  const size_t rows = whole ? (size_t)m + kTile : (size_t)kUnits * 2 * kTile;
  return kUnits * sizeof(PairStage<T>) + rows * rec;
}

// a record's bytes for a score's Ends
template <typename Score>
constexpr size_t fused_rec() {
  return Ends<Score>::kVals * sizeof(float);
}

template <typename Score, typename T, bool kWhole>
__global__ void __launch_bounds__(kThreads * kUnits, 1)
    tri_build_fused_kernel(
    const Score score, const float* __restrict__ P1,
    const float* __restrict__ P2, const int* __restrict__ A,
    const int* __restrict__ m_trues, T* __restrict__ out, int m, int t,
    int n, int q, long long S, float affeps, bool vec) {
  constexpr int D = Score::D;
  extern __shared__ __align__(16) uint8_t smem[];
  const int unit = threadIdx.x / kThreads, tid = threadIdx.x % kThreads;
  PairStage<T>& st = reinterpret_cast<PairStage<T>*>(smem)[unit];
  float* ends =
      reinterpret_cast<float*>(smem + kUnits * sizeof(PairStage<T>));

  const int w = blockIdx.x;
  const float* p1 = P1 + (size_t)w * m * D;
  const float* p2 = P2 + (size_t)w * m * D;
  const int* a = A + (size_t)w * m * 2;
  T* M = out + (size_t)w * (size_t)(2 * t) * (size_t)S;
  T* C = M + (long long)t * S;
  const int lim = m_trues[w];
  // the endpoint records: whole, m of them; else the unit's, its pair's
  // row sub-tile [0 .. kTile) and column sub-tile [kTile .. 2 kTile)
  constexpr int R = Ends<Score>::kVals;
  float* e = kWhole ? ends : ends + (size_t)unit * 2 * kTile * R;
  // the units claim pairs as they finish them (a mirrored pair writes
  // twice the bytes, a diagonal one scores half the pairs): unit u takes
  // pair u first, then the next unclaimed one, counted in shared memory
  __shared__ int next, claimed[kUnits];
  if (threadIdx.x == 0) next = kUnits;
  if (kWhole)
    stage_ends<Score>(p1, p2, a, 0, m, e, threadIdx.x, kThreads * kUnits);
  clear_stage(st, true, tid);
  __syncthreads();
  const int pairs = n * (n + 1) / 2, bar = 1 + unit;
  for (int k = unit; k < pairs;) {
    const SubPair p = sub_pair(k, n, q, t, m / t, S);
    if (kWhole) {
      build_sub_pair<true>(score, e + (size_t)p.gr0 * R,
                           e + (size_t)p.gc0 * R, p, lim, affeps, M, C, S,
                           vec, st, tid, bar);
    } else {
      // one row a thread, as tri_build.cu stages them
      const int half = tid / kTile, row = tid % kTile;
      if (half == 0)
        stage_ends<Score>(p1, p2, a, p.gr0, p.rows, e, row, kTile);
      else if (!p.diag)
        stage_ends<Score>(p1, p2, a, p.gc0, p.cols, e + kTile * R, row,
                          kTile);
      unit_sync(bar);
      build_sub_pair<true>(score, e, e + (p.diag ? 0 : kTile * R), p, lim,
                           affeps, M, C, S, vec, st, tid, bar);
    }
    // the chunks this thread wrote out, zeroed for the next pair
    clear_written<T>(st.codes[0], tid);
    if (p.mirror) clear_written<T>(st.codes[1], tid);
    if (tid == 0) claimed[unit] = atomicAdd(&next, 1);
    unit_sync(bar);  // the claim is seen, the stage and sub-tiles are free
    k = claimed[unit];
  }
}

// the largest dynamic shared memory a block of this device may take
int fused_smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

template <typename T, bool kWhole, typename Score>
int fused_launch_as(const Score& score, const void* P1, const void* P2,
                    const void* A, const void* m_trues, void* out, int W,
                    int m, int t, long long S, float affeps, void* stream) {
  const size_t bytes = fused_smem<T>(m, kWhole, fused_rec<Score>());
  cudaError_t e = cudaFuncSetAttribute(
      tri_build_fused_kernel<Score, T, kWhole>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const int q = (t + kTile - 1) / kTile;
  const int n = (m / t) * q;
  const bool vec = t * sizeof(T) % 16 == 0;
  tri_build_fused_kernel<Score, T, kWhole>
      <<<W, kThreads * kUnits, bytes, (cudaStream_t)stream>>>(
          score, (const float*)P1, (const float*)P2, (const int*)A,
          (const int*)m_trues, (T*)out, m, t, n, q, S, affeps, vec);
  return (int)cudaGetLastError();
}

// Build W problems into out (W, 2t, S) of T with the score Score(p),
// one block a problem, after the entries' argument checks.
template <typename T, typename Score>
int tri_build_fused_run(const double (&p)[4], const void* P1, const void* P2,
                        const void* A, const void* m_trues, void* out, int W,
                        int m, int t, long long S, double affeps,
                        void* stream) {
  if (t < 1 || m % t || W < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)(m / t) * ((t + kTile - 1) / kTile);
  const int limit = fused_smem_limit();
  if (n * (n + 1) / 2 > 0x7fffffffLL || limit < 0)
    return (int)cudaErrorInvalidValue;
  const Score score(p);
  if (fused_smem<T>(m, true, fused_rec<Score>()) <= (size_t)limit)
    return fused_launch_as<T, true>(score, P1, P2, A, m_trues, out, W, m, t,
                                    S, (float)affeps, stream);
  return fused_launch_as<T, false>(score, P1, P2, A, m_trues, out, W, m, t,
                                   S, (float)affeps, stream);
}

// 1 where a block stages a problem's m endpoint records of rec bytes
// whole in storage T's build, 0 where each unit stages its pair's two
// sub-tiles; -1 where the device cannot be asked.
template <typename T>
int fused_whole(int m, int rec) {
  const int limit = fused_smem_limit();
  if (limit < 0 || rec < 1) return -1;
  return fused_smem<T>(m, true, (size_t)rec) <= (size_t)limit ? 1 : 0;
}

}  // namespace
