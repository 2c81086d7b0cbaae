// Batched dual matvec over flat upper-triangle pool storage, for Hopper.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:make_tri_pool_matvec
// (Pallas body :184-195, math _seg_matvec_lane :93-149).
//
// What it computes. Storage is (P, 2t, S) with S = t * nt (nt + 1) / 2:
// row-block r's upper tiles (r, r..nt-1) sit side by side at column
// off_r * t, off_r = r nt - r (r - 1) / 2; rows 0:t hold M's tile, rows t:2t
// C's. Lane b reads problem idx[b] and its K candidate rows U[b] (K, m),
// and writes out[b] = [M U^T; C U^T]^T as (K, 2m): for every output
// row-block j, the forward products of tiles (j, c >= j) and the transposed
// products of the strictly-upper tiles (r < j, j). Numerics as the JAX
// kernel's: int8 codes 0..127 become bf16 exactly, storage and u are bf16,
// products accumulate in f32, and the 1/127 scale is applied at the end.
//
// What bounds it on this card. Each tick reads every lane's whole triangle
// once (B * 2t * S bytes for int8: 168 MB at B=128, m=1024) against 2 K
// flops per stored element and direction: ~45 flops/byte at K=16, far below
// the ~295 flops/byte where the bf16 tensor cores would bind. It is bound by
// bytes, so the design reads every stored byte from HBM once.
//
// Design: one read of each tile. M u and C u are independent, so one
// block per (half h, lane b) owns that half's whole output row (K, m) and
// reads only its half's rows of the lane's tiles: tile (r, c)'s t rows of
// half h leave HBM once, in panels of 64 rows. No block needs another's
// data, so there is no cluster, and nt (1 to 16 in the pool) is bounded
// only by the output row. A producer warp copies each panel into a ring of
// shared-memory stages with 2-D tensor-map copies (cp.async.bulk.tensor
// over the (P 2t, S) view of the storage, the row taken from idx[b]; the
// TMA engine), one (64 rows, 128 bytes) box a copy, that complete on the
// stage's "full" mbarrier (one bulk copy a row, 256 bytes at int8, left
// the copies alone well under the memory rate). Eight consumer warps wait
// on it, take BOTH products from the staged copy, and release the stage on
// its "empty" mbarrier, which the producer waits on before refilling it.
// Fragments come from the stage by ldmatrix (forward: the tile's rows are
// outputs) and ldmatrix.trans (transposed: its columns are outputs). The
// candidates' blocks of each tile (u_c for the forward product, u_r for
// the transposed one) are bulk-copied into one of two u slots with
// barriers of their own, so both mma operands come from shared memory
// (read through L1 instead, each u fragment load touches 8 rows of u, and
// at K=16 those loads, not bytes, held the kernel back). The storage tile
// is the m16 operand of mma.sync.m16n8k16 and the K candidates the n8
// operand, so one n8 serves K <= 8 (the K=1 init calls waste 7 of 8
// columns, not 15 of 16 rows). int8 codes become bf16 by the bias trick
// (bf16_mma.cuh); bf16 storage is used as it is.
//
// The kernel is tri_matvec_mma.cuh's, with the flat address map
// (FlatTiles); tri_tiles_matvec.cu runs the same kernel over tile-major
// storage. The panel products (forward and transposed, int8 and bf16
// fragments) are bf16_mma.cuh's, shared with the capacity engines'
// kernels; the copies, barriers and the tensor map are hopper_copy.cuh's.
// The copies swizzle each 128-byte row segment's 16-byte chunks by the
// row, so the 8 rows of an ldmatrix hit distinct banks, except the
// forward's even rows at int8, which meet in pairs (a 2-way conflict).
//
// Determinism. A block walks its tiles in storage order (r = 0..nt-1,
// c = r..nt-1) and owns its outputs outright: no atomics. Forward products
// of row r accumulate in registers; block c's raw sums live in the output
// buffer between tiles: before tile (r, c) the thread that owns them loads
// them (0 at r = 0; loaded ahead, so the latency hides behind the tile),
// adds the tile's transposed panel products in order and stores them back,
// all in program order. When row r ends, block r's outputs are final:
// (transposed sums r' = 0..r-1 + forward sum) * scale. Every output is
// summed in one fixed order, so a rerun reproduces every lane bit for bit.
// The output buffer's read-backs stay in L2 (B * K * 2m * 4 bytes: 17 MB at
// B=128, K=16, m=1024); HBM sees each stored byte once.
//
// Routes by tile (the dispatch below, which reports the route it took
// through `route`; the wrapper counts each route's launches under its own
// key, and ops/flattri.matvec_route mirrors the rule):
//   "mma"   int8 / bf16 at t = 128, 256, 384, 512 (a multiple of 128
//           whose panels, boxes and ring fit): the kernel above;
//   "super" int8 / bf16 at every other multiple of 16: the same consumer
//           at t = 128 over the matrix's 128-row super-tiles, each panel
//           assembled from (kG rows, 128 bytes) boxes of the stored rows,
//           kG the largest of 64, 32, 16 dividing t (tri_matvec_mma.cuh:
//           tri_super_kernel, FlatSuper);
//   "core"  int8 / bf16 at every other t <= 7680 dividing m:
//           tri_matvec_core.cuh's CUDA-core kernel (runs of 64 products
//           summed in f32, the runs in f64).
// The float / double storage kinds have one route, that CUDA-core kernel
// at every t <= 7680 (f32 products for f32 storage, f64 for f64, the runs
// in f64, as the JAX package's sums in the storage's type), counted under
// the kernel's own key. Their times on an H100 are in PERF.md.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tri_matvec_core.cuh"
#include "tri_matvec_mma.cuh"

namespace {

// the tensor-core kernel at tile T, NK n8 groups of candidates
template <typename S, int T>
int launch_tile(const CUtensorMap& map, const void* idx, const void* U,
                void* out, int B, int K, int nt, float scale,
                cudaStream_t st) {
  return K <= 8 ? launch_mma<S, T, 1, FlatTiles>(map, idx, U, out, B, K, nt,
                                                 scale, st)
                : launch_mma<S, T, 2, FlatTiles>(map, idx, U, out, B, K, nt,
                                                 scale, st);
}

template <typename S>
int dispatch(const void* tri, const void* idx, const void* U, void* out,
             int P, int B, int K, int nt, int t, long long S_cols,
             float scale, void* stream, int* route) {
  if (K < 1 || K > 16 || B < 1 || B > 65535 || nt < 1 || P < 1 || t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (super_tile(t)) {  // route "super"
    *route = kRouteSuper;
    return launch_super<S, false>(tri, (long long)P * 2 * t, S_cols, idx, U,
                                  out, B, K, nt, t, scale, st);
  }
  if (!mma_tile(t)) {  // route "core"
    *route = kRouteCore;
    return core::launch_core<S>(tri, idx, U, out, B, K, nt,
                                core::Flat{S_cols, t}, scale, st);
  }
  *route = kRouteMma;  // route "mma"
  CUtensorMap map;
  const cudaError_t err =
      storage_map<S>(&map, tri, (long long)P * 2 * t, S_cols, kPanel);
  if (err != cudaSuccess) return (int)err;
  switch (t) {
    case 128:
      return launch_tile<S, 128>(map, idx, U, out, B, K, nt, scale, st);
    case 256:
      return launch_tile<S, 256>(map, idx, U, out, B, K, nt, scale, st);
    case 384:
      return launch_tile<S, 384>(map, idx, U, out, B, K, nt, scale, st);
    default:
      return launch_tile<S, 512>(map, idx, U, out, B, K, nt, scale, st);
  }
}

}  // namespace

extern "C" {

// tri (P, 2t, S) int8 codes in 0..127, idx (B,) int32, U (B, K, m) bf16,
// out (B, K, 2m) f32; any t >= 1 (t <= 7680 off the tensor cores), K <=
// 16; tri 16-byte aligned (routes "mma" and "super"); *route set to the
// route taken (kRouteMma, kRouteSuper, kRouteCore).
int tri_matvec_int8(const void* tri, const void* idx, const void* U, void* out,
                    int P, int B, int K, int nt, int t, long long S,
                    float scale, void* stream, int* route) {
  return dispatch<int8_t>(tri, idx, U, out, P, B, K, nt, t, S, scale,
                          stream, route);
}

// tri (P, 2t, S) bf16, the rest as tri_matvec_int8 (no scale).
int tri_matvec_bf16(const void* tri, const void* idx, const void* U, void* out,
                    int P, int B, int K, int nt, int t, long long S,
                    void* stream, int* route) {
  return dispatch<__nv_bfloat16>(tri, idx, U, out, P, B, K, nt, t, S, 1.f,
                                 stream, route);
}

int tri_matvec_f32(const void* tri, const void* idx, const void* U, void* out,
                   int B, int K, int nt, int t, long long S, void* stream) {
  return core::launch_core<float>(tri, idx, U, out, B, K, nt,
                                  core::Flat{S, t}, 1.f,
                                  (cudaStream_t)stream);
}

int tri_matvec_f64(const void* tri, const void* idx, const void* U, void* out,
                   int B, int K, int nt, int t, long long S, void* stream) {
  return core::launch_core<double>(tri, idx, U, out, B, K, nt,
                                   core::Flat{S, t}, 1.f,
                                   (cudaStream_t)stream);
}

}  // extern "C"
