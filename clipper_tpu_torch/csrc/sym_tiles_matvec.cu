// Single-problem dual matvec over the symmetric-triangle tile list, for
// Hopper.
//
// Replaces the TPU kernel
// clipper_tpu/ops/symstore.py:make_sym_dual_matvec_pallas (Pallas body
// :360-390, launch :398-417), and serves the function the XLA tile matvec
// computes with explicit coordinates (symstore.py:226-311): the
// single-device tile-list solve and each rank's slice in the
// triangle-sharded engine.
//
// What it computes. Storage is (T, 2t, t): tile k holds block (rows[k],
// cols[k]) of the upper triangle, rows 0:t M's tile and rows t:2t C's; an
// inert slot (nt, nt) is a zero tile. Given the K candidate rows U (K, m),
// the kernel writes out = [M U'; C U']' as (K, 2m): for every stored tile
// k = (r, c), the forward product tile_k @ u[c] into block r, and for
// r != c the transposed product tile_k' @ u[r] into block c (a diagonal tile
// already holds its full symmetric content, symstore.py:231-233, 290-300).
// Tile partials are summed in f64 and rounded once to f32 (raw = 0), or
// written unrounded in f64 (raw = 1) for the sharded engine, which sums
// the ranks' slices before that one rounding.
//
// int8 and bf16 storage (route "units": t = 128, or a multiple of it read
// as 128-row tiles): the design of csrc/sym_tile_mma.cuh.
// The storage is read as a 2-D tensor of T 2t rows and t columns; the
// host's plan (ops/symstore.tiles_plan, built once a storage) groups the
// tiles into units of up to R row blocks by S column blocks, and one block
// per unit and half of [M; C] reads each of its half-tiles once, applies
// it both ways and keeps its sums in registers; a second kernel sums the
// units' f64 partials per output block in a fixed order. Inert slots are
// in no unit and never read. At m = 65,536 (K = 16) the tile list is
// 131,328 x 32 KB = 4.30 GB, 1.28 ms at 3.35 TB/s, and the products 2.7e11
// bf16 flops, 0.28 ms at 989 TFLOP/s: bound by bytes, which the design
// moves once, plus about 0.31 of them (0.16 in bf16, 0.02 at K = 1) in the
// workspace of partials. K > 16 takes groups of 16 candidates on
// blockIdx.z, each of which reads the tiles again.
//
// Routes by tile (sym_tile_mma.cuh; ops/symstore.matvec_route picks):
// int8 / bf16 at t a multiple of 128 take the unit kernel ("units"), the
// plan holding each stored t-tile as its 128-row tiles; at every other t
// ("core") the CUDA-core kernel below on the codes.
//
// float / double storage, and the codes' "core" route: one CUDA-core block
// per (output block j, group of at most 16 candidates), which owns its
// outputs outright. The host builds, once per storage
// (ops/symstore.tile_walks), each output block's walk: the forward tiles
// of row j, then the transposed tiles of column j, each in increasing k,
// as (k, 2 ub + tr) pairs with ub the block of u the tile contracts; inert
// slots are in no walk and never index u. Tile offsets are 64-bit:
// T * 2t * t passes 2^31.

#include "sym_tile_mma.cuh"

namespace {

using namespace symtile;

// CUDA-core tiles (float / double, and int8 / bf16 codes on the "core"
// route): one thread per output column, the same walk. F: the storage;
// UT: u's type (bf16 for codes, else F).
template <typename F, typename UT>
__global__ void __launch_bounds__(kThreads) sym_tiles_core_kernel(
    const F* __restrict__ tiles, const int2* __restrict__ walks,
    const int* __restrict__ offsets, const UT* __restrict__ U,
    void* __restrict__ out, int K, int nt, int t, int raw, float scale) {
  const int j = blockIdx.x;
  const int k0 = blockIdx.y * kMaxK;
  const int Kb = min(kMaxK, K - k0);
  const int m = nt * t;
  const size_t tile_elems = 2 * (size_t)t * t;
  const UT* Ub = U + (size_t)k0 * m;
  void* outb = raw ? (void*)((double*)out + (size_t)k0 * 2 * m)
                   : (void*)((float*)out + (size_t)k0 * 2 * m);
  const int e0 = offsets[j];
  const int e1 = offsets[j + 1];
  for (int o = threadIdx.x; o < 2 * t; o += blockDim.x) {
    double acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.0;
    for (int e = e0; e < e1; ++e) {
      const int2 w = walks[e];
      apply_tile(acc, tiles + (size_t)w.x * tile_elems, (size_t)t, Ub, Kb, m,
                 t, o, (w.y & 1) == 0, w.y >> 1);
    }
    store_sums(acc, outb, raw, Kb, m, t, j, o, scale);
  }
}

dim3 grid_of(int nt, int K) { return dim3(nt, (K + kMaxK - 1) / kMaxK); }

template <typename F, typename UT>
int launch_core(const void* tiles, const void* walks, const void* offsets,
                const void* U, void* out, int K, int nt, int t, int raw,
                float scale, void* stream) {
  if (K < 1 || nt < 1 || t < 1) return (int)cudaErrorInvalidValue;
  sym_tiles_core_kernel<F, UT><<<grid_of(nt, K), core_threads(t), 0,
                                 (cudaStream_t)stream>>>(
      (const F*)tiles, (const int2*)walks, (const int*)offsets,
      (const UT*)U, out, K, nt, t, raw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tiles (T, 2t, t) int8 codes in 0..127, as a view of rows = T 2t and
// cols = t; the plan of the list (ops/symstore.tiles_plan); U (K, m) bf16;
// out (K, 2m) f32 (raw = 0) or f64 (raw = 1); ws the plan's workspace for
// ceil(K / 16) groups; t a multiple of 128 (route "units"; the plan over
// the 128-grid).
int sym_tiles_matvec_int8(const void* tiles, long long rows, long long cols,
                          const void* entries, const void* units,
                          const void* fslots, int n_units,
                          const void* red_off, const void* red_slots,
                          int n_slots, const void* U, void* out, void* ws,
                          int K, int nt, int t, int raw, float scale,
                          void* stream) {
  return launch_units<int8_t>(tiles, rows, cols, entries, units, fslots,
                              n_units, red_off, red_slots, n_slots, U, out,
                              ws, K, nt, t, raw, scale, stream);
}

// the same over bf16 tiles (no scale)
int sym_tiles_matvec_bf16(const void* tiles, long long rows, long long cols,
                          const void* entries, const void* units,
                          const void* fslots, int n_units,
                          const void* red_off, const void* red_slots,
                          int n_slots, const void* U, void* out, void* ws,
                          int K, int nt, int t, int raw, void* stream) {
  return launch_units<__nv_bfloat16>(tiles, rows, cols, entries, units,
                                     fslots, n_units, red_off, red_slots,
                                     n_slots, U, out, ws, K, nt, t, raw, 1.f,
                                     stream);
}

// The "core" route of int8 codes (t not a multiple of 128): tiles
// (T, 2t, t); walks (E, 2) and offsets (nt + 1,) int32 from tile_walks;
// U (K, m) bf16; out as above (scaled by `scale` when raw = 0).
int sym_tiles_matvec_core_int8(const void* tiles, const void* walks,
                               const void* offsets, const void* U, void* out,
                               int K, int nt, int t, int raw, float scale,
                               void* stream) {
  return launch_core<int8_t, __nv_bfloat16>(tiles, walks, offsets, U, out, K,
                                            nt, t, raw, scale, stream);
}

// the same over bf16 tiles (no scale)
int sym_tiles_matvec_core_bf16(const void* tiles, const void* walks,
                               const void* offsets, const void* U, void* out,
                               int K, int nt, int t, int raw, void* stream) {
  return launch_core<__nv_bfloat16, __nv_bfloat16>(
      tiles, walks, offsets, U, out, K, nt, t, raw, 1.f, stream);
}

// tiles f32; walks (E, 2) and offsets (nt + 1,) int32 from tile_walks;
// U (K, m) f32, out as above.
int sym_tiles_matvec_f32(const void* tiles, const void* walks,
                         const void* offsets, const void* U, void* out, int K,
                         int nt, int t, int raw, void* stream) {
  return launch_core<float, float>(tiles, walks, offsets, U, out, K, nt, t,
                                   raw, 1.f, stream);
}

// tiles f64, U (K, m) f64, out as above.
int sym_tiles_matvec_f64(const void* tiles, const void* walks,
                         const void* offsets, const void* U, void* out, int K,
                         int nt, int t, int raw, void* stream) {
  return launch_core<double, double>(tiles, walks, offsets, U, out, K, nt, t,
                                     raw, 1.f, stream);
}

}  // extern "C"
