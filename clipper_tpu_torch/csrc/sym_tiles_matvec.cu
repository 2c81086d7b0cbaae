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
// Routes by tile (ops/symstore.matvec_route picks one, from t alone; the
// host's plan, ops/symstore.tiles_plan, built once a storage, gives every
// tile's place in the storage's 2-D view of T 2t rows of t; inert slots
// are in no plan and never read):
// - "units", int8 / bf16 at t a multiple of 16: the tensor-core unit
//   kernel of csrc/sym_tile_mma.cuh over 128-row tiles of the matrix (a
//   multiple of 128 read as its 128-row tiles; else super-tiles of 128
//   rows made of the storage's 64-, 32- or 16-row tiles). Units of up to
//   R row blocks by S column blocks, one block per unit and half of
//   [M; C], reading each of its half-tiles once, applying it both ways
//   and keeping its sums in registers; a second kernel sums the units'
//   f64 partials per output block in a fixed order. At m = 65,536 (K =
//   16) the tile list is 4.30 GB, 1.28 ms at 3.35 TB/s, and the products
//   2.7e11 bf16 flops, 0.28 ms at 989 TFLOP/s: bound by bytes, which the
//   design moves once, plus about 0.31 of them (0.16 in bf16, 0.02 at K =
//   1) in the workspace of partials. K > 16 takes groups of 16 candidates
//   on blockIdx.z, each of which reads the tiles again.
// - "core", int8 / bf16 at any other t, and "float", the f32 / f64 kinds
//   at every t: the CUDA-core kernel of csrc/sym_core.cuh on the same
//   kind of plan over the t-grid, bound by its operations.
// Tile offsets are 64-bit: T * 2t * t passes 2^31.

#include "sym_core.cuh"
#include "sym_tile_mma.cuh"

using symtile::kT;
using symtile::launch_units;

extern "C" {

// tiles (T, 2t, t) int8 codes in 0..127, as a view of rows = T 2t and
// cols = t; the plan of the list (ops/symstore.tiles_plan); U (K, m) bf16;
// out (K, 2m) f32 (raw = 0) or f64 (raw = 1); ws the plan's workspace for
// ceil(K / 16) groups; t a multiple of 128 (route "units"; the plan over
// the 128-grid).
int sym_tiles_matvec_int8(const void* tiles, long long rows, long long cols,
                          const void* entries, const void* units,
                          const void* fslots, int n_units, const void* red_off,
                          const void* red_slots, int n_slots, const void* U,
                          void* out, void* ws, int K, int nt, int t, int raw,
                          float scale, void* stream) {
  return launch_units<int8_t>(tiles, rows, cols, entries, units, fslots,
                              n_units, red_off, red_slots, n_slots, nullptr,
                              kT, U, out, ws, K, nt, t, raw, scale, stream);
}

// the same over bf16 storage (no scale)
int sym_tiles_matvec_bf16(const void* tiles, long long rows, long long cols,
                          const void* entries, const void* units,
                          const void* fslots, int n_units, const void* red_off,
                          const void* red_slots, int n_slots, const void* U,
                          void* out, void* ws, int K, int nt, int t, int raw,
                          void* stream) {
  return launch_units<__nv_bfloat16>(tiles, rows, cols, entries, units,
                                     fslots, n_units, red_off, red_slots,
                                     n_slots, nullptr, kT, U, out, ws, K, nt,
                                     t, raw, 1.f, stream);
}

// The "units" route at t a multiple of 16 but not of 128: as
// sym_tiles_matvec_int8, over the plan's super-tiles of 128 rows
// (sym_tile_mma.cuh's Sub: subs, kP x kP int2 an entry; g the sub-tile,
// 64, 32 or 16).
int sym_tiles_matvec_sub_int8(const void* tiles, long long rows, long long cols,
                              const void* entries, const void* units,
                              const void* fslots, int n_units,
                              const void* red_off, const void* red_slots,
                              int n_slots, const void* subs, int g,
                              const void* U, void* out, void* ws, int K, int nt,
                              int t, int raw, float scale, void* stream) {
  return launch_units<int8_t>(tiles, rows, cols, entries, units, fslots,
                              n_units, red_off, red_slots, n_slots, subs, g,
                              U, out, ws, K, nt, t, raw, scale, stream);
}

// the same over bf16 storage (no scale)
int sym_tiles_matvec_sub_bf16(const void* tiles, long long rows, long long cols,
                              const void* entries, const void* units,
                              const void* fslots, int n_units,
                              const void* red_off, const void* red_slots,
                              int n_slots, const void* subs, int g,
                              const void* U, void* out, void* ws, int K, int nt,
                              int t, int raw, void* stream) {
  return launch_units<__nv_bfloat16>(tiles, rows, cols, entries, units,
                                     fslots, n_units, red_off, red_slots,
                                     n_slots, subs, g, U, out, ws, K, nt, t,
                                     raw, 1.f, stream);
}

// The "core" route (csrc/sym_core.cuh): int8 codes at t not a multiple
// of 16. tiles (T, 2t, t) viewed with rows of ld elements; the plan of
// ops/symstore.core_plan over the t-grid (fslots R a unit); U (K, m)
// bf16; out as above; ws the plan's workspace (groups of
// symcore::core_group(t) candidates).
int sym_tiles_matvec_core_int8(const void* tiles, long long ld,
                               const void* entries, const void* units,
                               const void* fslots, int n_units, int R,
                               const void* red_off, const void* red_slots,
                               int n_slots, const void* U, void* out, void* ws,
                               int K, int nt, int t, int raw, float scale,
                               void* stream) {
  return symcore::launch_core<int8_t, __nv_bfloat16>(
      tiles, ld, entries, units, fslots, n_units, R, red_off, red_slots,
      n_slots, U, out, ws, K, nt, t, raw, scale, stream);
}

// the same over bf16 storage (no scale)
int sym_tiles_matvec_core_bf16(const void* tiles, long long ld,
                               const void* entries, const void* units,
                               const void* fslots, int n_units, int R,
                               const void* red_off, const void* red_slots,
                               int n_slots, const void* U, void* out, void* ws,
                               int K, int nt, int t, int raw, void* stream) {
  return symcore::launch_core<__nv_bfloat16, __nv_bfloat16>(
      tiles, ld, entries, units, fslots, n_units, R, red_off, red_slots,
      n_slots, U, out, ws, K, nt, t, raw, 1.f, stream);
}

// the "float" route: the same over f32 and f64 storage, U of the
// storage's type (products and sums in f64)
int sym_tiles_matvec_core_f32(const void* tiles, long long ld,
                              const void* entries, const void* units,
                              const void* fslots, int n_units, int R,
                              const void* red_off, const void* red_slots,
                              int n_slots, const void* U, void* out, void* ws,
                              int K, int nt, int t, int raw, void* stream) {
  return symcore::launch_core<float, float>(
      tiles, ld, entries, units, fslots, n_units, R, red_off, red_slots,
      n_slots, U, out, ws, K, nt, t, raw, 1.f, stream);
}

int sym_tiles_matvec_core_f64(const void* tiles, long long ld,
                              const void* entries, const void* units,
                              const void* fslots, int n_units, int R,
                              const void* red_off, const void* red_slots,
                              int n_slots, const void* U, void* out, void* ws,
                              int K, int nt, int t, int raw, void* stream) {
  return symcore::launch_core<double, double>(
      tiles, ld, entries, units, fslots, n_units, R, red_off, red_slots,
      n_slots, U, out, ws, K, nt, t, raw, 1.f, stream);
}

}  // extern "C"
