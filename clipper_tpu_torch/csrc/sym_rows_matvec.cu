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
// int8 and bf16 storage (route "units": t = 128, or a multiple of it read
// as 128-row tiles). The storage is read as a 2-D tensor of
// n 2t rows and G t columns, and the host's plan (ops/symstore.rows_plan,
// built once a storage and slice: the closed form above, restricted to the
// slice) gives every stored tile's place in it; pad tiles and pad chunks are
// in no plan and never read. The kernel is the tile list's
// (csrc/sym_tile_mma.cuh): each stored tile leaves device memory once a
// call, and the workspace of f64 partials adds about 0.31 of the tile bytes
// at K = 16 in int8 (0.16 in bf16, 0.02 at K = 1). At m = 65,536, G = 32 the
// tiles are 131,328 x 32 KB = 4.30 GB, 1.28 ms at 3.35 TB/s: bound by
// bytes (the products, 2.7e11 bf16 flops, take 0.28 ms at 989 TFLOP/s).
// Chunk offsets fit the view's int32 coordinates; the storage at
// m = 65,536 is 4.56 GB.
//
// Summation. An output at m = 65,536 sums 512 tiles; a long f32 running
// sum (and the tensor cores truncate each mma's sum) drifted 8.5e-3 from
// the plain version on outputs near 70, where 1e-4 is about 10 ulps. So
// every tile's product starts from zero, and the f32 tile partials are
// added in f64: the result is the exact sum to within the tile partials'
// rounding, rounded once to f32 (the JAX kernel's f32 result type) and
// scaled in f32, as the plain version does. The JAX kernel keeps an f32
// accumulator instead, so this kernel is the more exact of the two
// (ROADMAP.md Queue 3).
//
// Routes by tile (sym_tile_mma.cuh; ops/symstore.matvec_route picks):
// int8 / bf16 at t a multiple of 128 take the unit kernel ("units"), the
// plan holding each stored t-tile as its 128-row tiles; at every other t
// ("core") the CUDA-core kernel below on the codes.
//
// The float / double storage kinds, and the codes' "core" route, take a
// plain CUDA-core kernel: one block per output row block j, which walks
// row j's tiles forward, then column j's transposed (the ranges of the
// slice: c's from the closed form, r's by a binary search on the chunk
// index first(r) + (j - r) / G, which grows with r), summing in f64 and
// rounding to f32 as well.

#include "sym_tile_mma.cuh"

namespace {

using namespace symtile;

__device__ __forceinline__ long long tri_chunks_below(long long n, int G) {
  const long long q = n / G;
  return (long long)G * q * (q + 1) / 2 + (n - q * G) * (q + 1);
}

// first chunk of row block r
__device__ __forceinline__ long long first_chunk(int r, int nt, int G) {
  return tri_chunks_below(nt, G) - tri_chunks_below(nt - r, G);
}

// canonical chunk index of tile (r, c), c >= r
__device__ __forceinline__ long long chunk_of(int r, int c, int nt, int G) {
  return first_chunk(r, nt, G) + (c - r) / G;
}

// element offset of tile (r, c) in a slice starting at chunk base, and its
// row stride G t
__device__ __forceinline__ size_t tile_offset(int r, int c, int nt, int t,
                                              int G, long long base) {
  const long long k = chunk_of(r, c, nt, G) - base;
  return (size_t)k * (size_t)(2 * t) * (size_t)(G * t) +
         (size_t)((c - r) % G) * (size_t)t;
}

// smallest r in [0, j] whose tile (r, j) sits in a chunk >= bound (j when
// none): chunk_of(r, j) grows with r, as no two rows share a chunk
__device__ __forceinline__ int first_row_from(long long bound, int j, int nt,
                                              int G) {
  int lo = 0, hi = j;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (chunk_of(mid, j, nt, G) >= bound)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// the first `chunks` chunks of a row cover chunks * G of its span columns
__device__ __forceinline__ long long clamp_cols(long long chunks, int G,
                                                long long span) {
  const long long cols = chunks > 0 ? chunks * G : 0;
  return cols < span ? cols : span;
}

// block j's walk over the slice [base, base + n): forward columns
// [c_lo, c_hi) of row j, transposed rows [r_lo, r_hi) of column j
struct Walk {
  int c_lo, nf, r_lo, total;
  __device__ __forceinline__ Walk(int j, int nt, int G, long long base,
                                  long long n) {
    const long long fj = first_chunk(j, nt, G);
    const long long span = nt - j;
    const long long lo = clamp_cols(base - fj, G, span);
    const long long hi = clamp_cols(base + n - fj, G, span);
    c_lo = j + (int)lo;
    nf = (int)(hi - lo);
    r_lo = first_row_from(base, j, nt, G);
    total = nf + first_row_from(base + n, j, nt, G) - r_lo;
  }
  // tile `it`: forward tiles (j, c_lo + it) first, then the transposed
  // tiles (r_lo + it - nf, j)
  __device__ __forceinline__ void at(int it, int j, int& r, int& c,
                                     bool& fwd) const {
    fwd = it < nf;
    r = fwd ? j : r_lo + it - nf;
    c = fwd ? c_lo + it : j;
  }
};

bool bad_args(int K, int G, long long base, long long n) {
  return K < 1 || K > kMaxK || G < 1 || base < 0 || n < 0;
}

// CUDA-core tiles (float / double storage, and int8 / bf16 codes on the
// "core" route): one thread per output column, K <= 16 f64 sums in
// registers, the same fixed tile order, rounded to f32 at the end and
// scaled. F: the storage; UT: u's type (bf16 for codes, else F).
template <typename F, typename UT>
__global__ void __launch_bounds__(kThreads) sym_rows_core_kernel(
    const F* __restrict__ chunks, const UT* __restrict__ U,
    void* __restrict__ out, int K, int nt, int t, int G, long long base,
    long long n, int raw, float scale) {
  const int j = blockIdx.x;
  const int m = nt * t;
  const size_t Gt = (size_t)G * t;
  const Walk w(j, nt, G, base, n);
  for (int o = threadIdx.x; o < 2 * t; o += blockDim.x) {
    double acc[kMaxK];
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) acc[k] = 0.0;
    for (int it = 0; it < w.total; ++it) {
      int r, c;
      bool fwd;
      w.at(it, j, r, c, fwd);
      apply_tile(acc, chunks + tile_offset(r, c, nt, t, G, base), Gt, U, K,
                 m, t, o, fwd, fwd ? c : r);
    }
    store_sums(acc, out, raw, K, m, t, j, o, scale);
  }
}

template <typename F, typename UT>
int launch_core(const void* chunks, const void* U, void* out, int K, int nt,
                int t, int G, long long base, long long n, int raw,
                float scale, void* stream) {
  if (bad_args(K, G, base, n) || nt < 1 || t < 1)
    return (int)cudaErrorInvalidValue;
  sym_rows_core_kernel<F, UT><<<nt, core_threads(t), 0,
                                (cudaStream_t)stream>>>(
      (const F*)chunks, (const UT*)U, out, K, nt, t, G, base, n, raw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// chunks: the chunk range [base, base + n) of the (NC, 2t, G t) int8
// storage (codes in 0..127), as a view of rows = n 2t and cols = G t; the
// plan of that slice (ops/symstore.rows_plan); U (K, m) bf16; out (K, 2m)
// f32 (raw = 0) or f64 (raw = 1); ws the plan's workspace; t a multiple
// of 128 (route "units"; the plan over the 128-grid).
int sym_rows_matvec_int8(const void* chunks, long long rows, long long cols,
                         const void* entries, const void* units,
                         const void* fslots, int n_units,
                         const void* red_off, const void* red_slots,
                         int n_slots, const void* U, void* out, void* ws,
                         int K, int nt, int t, int raw, float scale,
                         void* stream) {
  return launch_units<int8_t>(chunks, rows, cols, entries, units, fslots,
                              n_units, red_off, red_slots, n_slots, U, out,
                              ws, K, nt, t, raw, scale, stream);
}

// the same over bf16 storage (no scale)
int sym_rows_matvec_bf16(const void* chunks, long long rows, long long cols,
                         const void* entries, const void* units,
                         const void* fslots, int n_units,
                         const void* red_off, const void* red_slots,
                         int n_slots, const void* U, void* out, void* ws,
                         int K, int nt, int t, int raw, void* stream) {
  return launch_units<__nv_bfloat16>(chunks, rows, cols, entries, units,
                                     fslots, n_units, red_off, red_slots,
                                     n_slots, U, out, ws, K, nt, t, raw, 1.f,
                                     stream);
}

// The "core" route of int8 codes (t not a multiple of 128): chunks the
// slice [base, base + n) of (NC, 2t, G t) storage, U (K, m) bf16, out as
// above (scaled by `scale` when raw = 0).
int sym_rows_matvec_core_int8(const void* chunks, const void* U, void* out,
                              int K, int nt, int t, int G, long long base,
                              long long n, int raw, float scale,
                              void* stream) {
  return launch_core<int8_t, __nv_bfloat16>(chunks, U, out, K, nt, t, G,
                                            base, n, raw, scale, stream);
}

// the same over bf16 storage (no scale)
int sym_rows_matvec_core_bf16(const void* chunks, const void* U, void* out,
                              int K, int nt, int t, int G, long long base,
                              long long n, int raw, void* stream) {
  return launch_core<__nv_bfloat16, __nv_bfloat16>(
      chunks, U, out, K, nt, t, G, base, n, raw, 1.f, stream);
}

// chunks f32, U (K, m) f32, out as above.
int sym_rows_matvec_f32(const void* chunks, const void* U, void* out, int K,
                        int nt, int t, int G, long long base, long long n,
                        int raw, void* stream) {
  return launch_core<float, float>(chunks, U, out, K, nt, t, G, base, n, raw,
                                   1.f, stream);
}

// chunks f64, U (K, m) f64, out as above.
int sym_rows_matvec_f64(const void* chunks, const void* U, void* out, int K,
                        int nt, int t, int G, long long base, long long n,
                        int raw, void* stream) {
  return launch_core<double, double>(chunks, U, out, K, nt, t, G, base, n,
                                     raw, 1.f, stream);
}

}  // extern "C"
