// Single-problem dual matvec over row-chunked symmetric-triangle storage,
// for Hopper.
//
// Replaces the TPU kernel
// clipper_tpu/ops/symstore.py:make_sym_dual_matvec_pallas_rows (Pallas body
// :692-732, launch :754-765).
//
// What it computes. Storage is (NC, 2t, G t): row block r's upper tiles
// (r, r..nt-1) sit in ceil((nt - r) / G) consecutive chunks of G tiles side
// by side; in each chunk rows 0:t hold M's tiles, rows t:2t C's, and a
// short row's pad tiles are zero. Row r's first chunk is
//   first(r) = S(nt) - S(nt - r),  S(n) = G q (q + 1) / 2 + (n - q G)(q + 1),
// q = n / G (ops/symstore.py:row_first_chunk), so tile (r, c), c >= r, sits
// in chunk first(r) + (c - r) / G at lanes ((c - r) % G) t. Given the K
// candidate rows U (K, m), the kernel writes out = [M U'; C U']' as (K, 2m)
// f32: for every output row block j, the forward products of tiles
// (j, c >= j) and the transposed products of tiles (r < j, j). The diagonal
// tile holds the full symmetric tile and is applied forward only (the
// masked transpose at symstore.py:723-724).
//
// A slice. The storage handed in may be the contiguous chunk range
// [base, base + n) of the canonical list (padded past NC with zero chunks),
// as one rank of the triangle-sharded engine holds it: only the tiles whose
// chunk lies in the range are applied, and the output is that slice's
// share, to be summed across ranks. raw = 1 writes the unscaled f64 sums
// instead of f32, so that the sum across ranks is taken before the one
// rounding. The whole list is base = 0, n = NC.
//
// Routes by tile (ops/symstore.matvec_route picks one, from t alone; the
// host's plan, ops/symstore.rows_plan, built once a storage and slice
// from the closed form above restricted to the slice, gives every tile's
// place in the storage's 2-D view of n 2t rows of G t, so pad tiles and
// pad chunks are in no plan and never read; chunk offsets fit the view's
// int32 coordinates, the storage at m = 65,536 being 4.56 GB):
// - "units", int8 / bf16 at t a multiple of 16: the tensor-core unit
//   kernel of csrc/sym_tile_mma.cuh, which reads each stored tile once a
//   call, over 128-row tiles of the matrix (a multiple of 128 read as its
//   128-row tiles; else super-tiles of 128 rows made of the storage's
//   64-, 32- or 16-row tiles, a box each). The workspace of f64 partials
//   adds about 0.31 of the tile bytes at K = 16 in int8 (0.16 in bf16,
//   0.02 at K = 1). At m = 65,536, G = 32 the tiles are 4.30 GB, 1.28 ms
//   at 3.35 TB/s: bound by bytes (the products, 2.7e11 bf16 flops, take
//   0.28 ms at 989 TFLOP/s).
// - "core", int8 / bf16 at any other t, and "float", the f32 / f64 kinds
//   at every t: the CUDA-core kernel of csrc/sym_core.cuh on the same kind
//   of plan over the t-grid, bound by its operations on the CUDA cores.
//
// Summation. An output at m = 65,536 sums 512 tiles; a long f32 running
// sum (and the tensor cores truncate each mma's sum) drifted 8.5e-3 from
// the plain version on outputs near 70, where 1e-4 is about 10 ulps. So
// every tile's product starts from zero (on the CUDA-core route, every
// run of kRun = 64 terms, sym_core.cuh), and the f32 partials are added in f64: the result is
// the exact sum to within the partials' rounding, rounded once to f32
// (the JAX kernel's f32 result type) and scaled in f32, as the plain
// version does. The JAX kernel keeps an f32 accumulator instead, so this
// kernel is the more exact of the two (ROADMAP.md Queue 3).

#include "sym_core.cuh"
#include "sym_tile_mma.cuh"

using symtile::kT;
using symtile::launch_units;

extern "C" {

// chunks: the chunk range [base, base + n) of the (NC, 2t, G t) int8
// storage (codes in 0..127), as a view of rows = n 2t and cols = G t; the
// plan of that slice (ops/symstore.rows_plan); U (K, m) bf16; out (K, 2m)
// f32 (raw = 0) or f64 (raw = 1); ws the plan's workspace; t a multiple
// of 128 (route "units"; the plan over the 128-grid).
int sym_rows_matvec_int8(const void* chunks, long long rows, long long cols,
                         const void* entries, const void* units,
                         const void* fslots, int n_units, const void* red_off,
                         const void* red_slots, int n_slots, const void* U,
                         void* out, void* ws, int K, int nt, int t, int raw,
                         float scale, void* stream) {
  return launch_units<int8_t>(chunks, rows, cols, entries, units, fslots,
                              n_units, red_off, red_slots, n_slots, nullptr,
                              kT, U, out, ws, K, nt, t, raw, scale, stream);
}

// the same over bf16 storage (no scale)
int sym_rows_matvec_bf16(const void* chunks, long long rows, long long cols,
                         const void* entries, const void* units,
                         const void* fslots, int n_units, const void* red_off,
                         const void* red_slots, int n_slots, const void* U,
                         void* out, void* ws, int K, int nt, int t, int raw,
                         void* stream) {
  return launch_units<__nv_bfloat16>(chunks, rows, cols, entries, units,
                                     fslots, n_units, red_off, red_slots,
                                     n_slots, nullptr, kT, U, out, ws, K, nt,
                                     t, raw, 1.f, stream);
}

// The "units" route at t a multiple of 16 but not of 128: as
// sym_rows_matvec_int8, over the plan's super-tiles of 128 rows
// (sym_tile_mma.cuh's Sub: subs, kP x kP int2 an entry; g the sub-tile,
// 64, 32 or 16).
int sym_rows_matvec_sub_int8(const void* chunks, long long rows, long long cols,
                             const void* entries, const void* units,
                             const void* fslots, int n_units,
                             const void* red_off, const void* red_slots,
                             int n_slots, const void* subs, int g,
                             const void* U, void* out, void* ws, int K, int nt,
                             int t, int raw, float scale, void* stream) {
  return launch_units<int8_t>(chunks, rows, cols, entries, units, fslots,
                              n_units, red_off, red_slots, n_slots, subs, g,
                              U, out, ws, K, nt, t, raw, scale, stream);
}

// the same over bf16 storage (no scale)
int sym_rows_matvec_sub_bf16(const void* chunks, long long rows, long long cols,
                             const void* entries, const void* units,
                             const void* fslots, int n_units,
                             const void* red_off, const void* red_slots,
                             int n_slots, const void* subs, int g,
                             const void* U, void* out, void* ws, int K, int nt,
                             int t, int raw, void* stream) {
  return launch_units<__nv_bfloat16>(chunks, rows, cols, entries, units,
                                     fslots, n_units, red_off, red_slots,
                                     n_slots, subs, g, U, out, ws, K, nt, t,
                                     raw, 1.f, stream);
}

// The "core" route (csrc/sym_core.cuh): int8 codes at t not a multiple
// of 16. chunks: the slice's storage viewed with rows of ld elements; the
// plan of ops/symstore.core_plan over the t-grid (fslots R a unit); U
// (K, m) bf16; out as above; ws the plan's workspace (groups of
// symcore::core_group(t) candidates).
int sym_rows_matvec_core_int8(const void* chunks, long long ld,
                              const void* entries, const void* units,
                              const void* fslots, int n_units, int R,
                              const void* red_off, const void* red_slots,
                              int n_slots, const void* U, void* out, void* ws,
                              int K, int nt, int t, int raw, float scale,
                              void* stream) {
  return symcore::launch_core<int8_t, __nv_bfloat16>(
      chunks, ld, entries, units, fslots, n_units, R, red_off, red_slots,
      n_slots, U, out, ws, K, nt, t, raw, scale, stream);
}

// the same over bf16 storage (no scale)
int sym_rows_matvec_core_bf16(const void* chunks, long long ld,
                              const void* entries, const void* units,
                              const void* fslots, int n_units, int R,
                              const void* red_off, const void* red_slots,
                              int n_slots, const void* U, void* out, void* ws,
                              int K, int nt, int t, int raw, void* stream) {
  return symcore::launch_core<__nv_bfloat16, __nv_bfloat16>(
      chunks, ld, entries, units, fslots, n_units, R, red_off, red_slots,
      n_slots, U, out, ws, K, nt, t, raw, 1.f, stream);
}

// the "float" route: the same over f32 and f64 storage, U of the
// storage's type (products and sums in f64)
int sym_rows_matvec_core_f32(const void* chunks, long long ld,
                             const void* entries, const void* units,
                             const void* fslots, int n_units, int R,
                             const void* red_off, const void* red_slots,
                             int n_slots, const void* U, void* out, void* ws,
                             int K, int nt, int t, int raw, void* stream) {
  return symcore::launch_core<float, float>(
      chunks, ld, entries, units, fslots, n_units, R, red_off, red_slots,
      n_slots, U, out, ws, K, nt, t, raw, 1.f, stream);
}

int sym_rows_matvec_core_f64(const void* chunks, long long ld,
                             const void* entries, const void* units,
                             const void* fslots, int n_units, int R,
                             const void* red_off, const void* red_slots,
                             int n_slots, const void* U, void* out, void* ws,
                             int K, int nt, int t, int raw, void* stream) {
  return symcore::launch_core<double, double>(
      chunks, ld, entries, units, fslots, n_units, R, red_off, red_slots,
      n_slots, U, out, ws, K, nt, t, raw, 1.f, stream);
}

}  // extern "C"
