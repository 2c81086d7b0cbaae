// Flat upper-triangle int8 or bf16 [M; C] build with one thread block per
// problem, for Hopper.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:build_tri_pallas_fused
// (:567-655), whose grid had one program per problem that computed all T
// upper tiles of its problem in one unrolled loop (the TPU's per-program
// cost made the per-tile grid of build_tri_pallas expensive). Here block
// w builds problem w by the body tri_build.cu runs (tri_pair_build.cuh):
// the two kernels write the same bytes, for both built-in invariants.
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
// (tri_build_fused_whole says which). At W=512, one block an SM runs in 4
// waves of 132. No pipeline selects it (the JAX package found it a wash
// against the per-tile grid).

#include <cuda_runtime.h>
#include <stdint.h>

#include "euclid_score.cuh"
#include "pointnormal_score.cuh"
#include "tri_pair_build.cuh"

namespace {

constexpr int kUnits = 8;  // units of kThreads threads a block

// dynamic shared memory of a block: the units' stages, then the
// endpoints, whole (kWhole: m records and kTile more, so that a sub-tile
// at the end has kTile readable ones) or a row and a column sub-tile a
// unit
template <typename T, int D>
size_t fused_smem(int m, bool whole) {
  const size_t rows = whole ? (size_t)m + kTile : (size_t)kUnits * 2 * kTile;
  return kUnits * sizeof(PairStage<T>) + rows * Ends<D>::kVals * 4;
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
  constexpr int R = Ends<D>::kVals;
  float* e = kWhole ? ends : ends + (size_t)unit * 2 * kTile * R;
  // the units claim pairs as they finish them (a mirrored pair writes
  // twice the bytes, a diagonal one scores half the pairs): unit u takes
  // pair u first, then the next unclaimed one, counted in shared memory
  __shared__ int next, claimed[kUnits];
  if (threadIdx.x == 0) next = kUnits;
  if (kWhole)
    stage_ends<D>(p1, p2, a, 0, m, e, threadIdx.x, kThreads * kUnits);
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
        stage_ends<D>(p1, p2, a, p.gr0, p.rows, e, row, kTile);
      else if (!p.diag)
        stage_ends<D>(p1, p2, a, p.gc0, p.cols, e + kTile * R, row, kTile);
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
int smem_limit() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

template <typename T, bool kWhole, typename Score>
int launch_as(const Score& score, const void* P1, const void* P2,
              const void* A, const void* m_trues, void* out, int W, int m,
              int t, long long S, float affeps, void* stream) {
  const size_t bytes = fused_smem<T, Score::D>(m, kWhole);
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

template <typename T, typename Score>
int launch(const Score& score, const void* P1, const void* P2, const void* A,
           const void* m_trues, void* out, int W, int m, int t, long long S,
           float affeps, void* stream) {
  const long long n = (long long)(m / t) * ((t + kTile - 1) / kTile);
  const int limit = smem_limit();
  if (n * (n + 1) / 2 > 0x7fffffffLL || limit < 0)
    return (int)cudaErrorInvalidValue;
  if (fused_smem<T, Score::D>(m, true) <= (size_t)limit)
    return launch_as<T, true>(score, P1, P2, A, m_trues, out, W, m, t, S,
                              affeps, stream);
  return launch_as<T, false>(score, P1, P2, A, m_trues, out, W, m, t, S,
                             affeps, stream);
}

template <typename T>
int build(const void* P1, const void* P2, const void* A, const void* m_trues,
          void* out, int W, int m, int t, long long S, int kind, double p0,
          double p1, double p2, double p3, double affeps, void* stream) {
  if (t < 1 || t > kMaxTile || m % t || W < 1)
    return (int)cudaErrorInvalidValue;
  const double p[4] = {p0, p1, p2, p3};
  if (kind == 0)
    return launch<T>(EuclidScore<float>(p), P1, P2, A, m_trues, out, W, m, t,
                     S, (float)affeps, stream);
  if (kind == 1)
    return launch<T>(PointNormalScore<float>(p), P1, P2, A, m_trues, out, W,
                     m, t, S, (float)affeps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The arguments of tri_build_int8 (tri_build.cu).
int tri_build_fused_int8(const void* P1, const void* P2, const void* A,
                         const void* m_trues, void* out, int W, int m, int t,
                         long long S, int kind, double p0, double p1,
                         double p2, double p3, double affeps, void* stream) {
  return build<int8_t>(P1, P2, A, m_trues, out, W, m, t, S, kind, p0, p1, p2,
                       p3, affeps, stream);
}

// The arguments of tri_build_bf16 (tri_build.cu).
int tri_build_fused_bf16(const void* P1, const void* P2, const void* A,
                         const void* m_trues, void* out, int W, int m, int t,
                         long long S, int kind, double p0, double p1,
                         double p2, double p3, double affeps, void* stream) {
  return build<__nv_bfloat16>(P1, P2, A, m_trues, out, W, m, t, S, kind, p0,
                              p1, p2, p3, affeps, stream);
}

// 1 where a block stages its problem's endpoints whole for m associations
// of kind (0 Euclidean, 1 point-normal) and storage bf16 (0 int8, 1
// bf16), 0 where each unit stages its pair's two sub-tiles; -1 where the
// device cannot be asked.
int tri_build_fused_whole(int m, int kind, int bf16) {
  const int limit = smem_limit();
  if (limit < 0 || (kind != 0 && kind != 1)) return -1;
  const size_t bytes =
      kind == 0 ? (bf16 ? fused_smem<__nv_bfloat16, 3>(m, true)
                        : fused_smem<int8_t, 3>(m, true))
                : (bf16 ? fused_smem<__nv_bfloat16, 6>(m, true)
                        : fused_smem<int8_t, 6>(m, true));
  return bytes <= (size_t)limit ? 1 : 0;
}

}  // extern "C"
