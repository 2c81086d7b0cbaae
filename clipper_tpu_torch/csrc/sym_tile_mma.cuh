// The design shared by the two symmetric-triangle dual matvecs,
// sym_rows_matvec.cu (row-chunked storage) and sym_tiles_matvec.cu (the
// tile list). Both apply stored (2t, t) [M; C] tiles to the K candidate
// rows U (K, m): tile (r, c) forward (its rows are outputs: block r) and,
// off the diagonal, transposed (its columns are outputs: block c). For
// int8 and bf16 tiles (t = 128) the two layouts differ only in where a
// tile sits, and the host's plan (ops/symstore.unit_plan) says that, so
// one kernel serves both.
//
// What bounds it on this card. At m = 65,536, K = 16 the stored tiles are
// 4.30 GB in int8 (8.61 in bf16), 1.28 ms (2.57) at 3.35 TB/s; the
// products are 2.7e11 bf16 flops, 0.28 ms at 989 TFLOP/s. It is bound by
// bytes, and every tile must leave device memory once. Measured on an H100
// (bench/sym_unit_probe): bf16 storage runs at its copies' rate; int8 at
// K = 16 is held back by per-tile work the copies do not hide, mostly the
// f32 -> f64 conversions of the exact sums (a unit that converts 16 a
// clock per SM) and the int8 code conversion.
//
// Design: one read of each tile, and sums that stay in registers.
// - Work units. The plan cuts the stored triangle into units, the tiles
//   with r / R == b and c / S == s (R = 8, S = 32), and a block
//   takes one unit and one half of [M; C] (rows 0:t of a tile are M's,
//   t:2t C's; the halves are independent). It walks the unit's tiles
//   column by column, rows inner, and reads each half-tile once: forward
//   into row r's sum, which lives across the whole unit, and, off the
//   diagonal, transposed into column c's sum, complete when the column
//   ends. The sums are f64 in registers (R + 1 blocks of t x K values over
//   the block's 256 consumer threads), never in shared memory, where a
//   read-modify-write of f64 sums a tile would move 4x the tile's bytes.
// - Partials. A unit writes each row's sum and each column's sum as an
//   f64 partial (K x t, [candidate][position]) into a slot of the
//   workspace. A second kernel, launched right after on the same stream,
//   sums each output block's slots in the plan's fixed order, rounds once
//   and scales (raw = 0, f32) or writes the f64 sums (raw = 1, for the
//   sharded engine to sum across ranks first). No atomics: a rerun is bit
//   identical. The workspace adds 2 (R + S) / (R S) of the int8 tile bytes
//   at K = 16 (written once and read once), half that in bf16, and 1/16 of
//   it at K = 1: about 1.31x, 1.16x and 1.02x the tile bytes at m = 65,536.
// - Staging, after kernel 1 (tri_matvec.cu). A ring of half-tile stages
//   is filled by 2-D tensor-map copies of (128 rows, 128 bytes) boxes with
//   the 128-byte swizzle (hopper_copy.cuh) that complete on the stage's
//   mbarrier; the unit's R row blocks of u are bulk-copied once, and each
//   column's block of u rides a ring of 8 slots beside the stages. Eight
//   warps take both products of every stage with ldmatrix and
//   ldmatrix.trans fragments (bf16_mma.cuh; int8 codes by the bias trick):
//   warp w owns output rows and columns 16 w .. 16 w + 15 of the tile.
//   There is no producer warp: the last warp to release a stage (a shared
//   counter) refills it, so no warp waits for another to free a stage and
//   each thread keeps up to 255 registers. mma.sync is enough: the
//   products are a fifth of the byte time.
//
// Numerics. Every tile's product runs in f32 on the tensor cores, its 8
// k16 steps chained from zero; tile partials are summed in f64 and the
// total rounded once to f32: the exact sum to within the partials'
// rounding. An output at m = 65,536 sums 512 tiles, where a running f32
// sum once drifted 8.5e-3 from the plain version (ROADMAP.md Queue 3).
//
// float / double tiles: one thread per output column, K f64 sums in
// registers, on CUDA cores (apply_tile_float, store_float).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper_copy.cuh"

namespace symtile {

using namespace hopper;

constexpr int kT = 128;             // the tensor-core kernels' tile
constexpr int kThreads = 256;       // the float and reduction kernels
constexpr int kMaxK = 16;           // candidate rows a block takes
constexpr int kUnitRows = 8;        // R: a unit's row blocks, whose sums a
                                    // block holds (symstore._UNIT_ROWS)
// Eight warps, each of which also refills the stages: two warps on each
// quarter of the SM's register file leave a thread up to 255 registers,
// room for the R + 1 blocks of f64 sums (a ninth, producer warp would put
// three on one quarter and cap every thread at 168, short of them).
constexpr int kWarps = 8;
constexpr int kUnitThreads = 32 * kWarps;
constexpr int kColSlots = 8;        // the ring of column blocks of u: >= kCount
constexpr int kMaxStages = 8;
constexpr int kSmemBudget = 227 * 1024;

// A plan entry is one stored tile, int4 {x, y, c, meta}: its element column
// and row in the storage's 2-D view (rows of its M half; the C half is t
// rows below), its column block c, and meta: the unit row i (bits 0-3),
// whether it is applied transposed (r != c), whether it starts or ends its
// column in the unit, whether the column's sum is written at its end, the
// column's slot in the ring of u blocks (its ordinal in the unit modulo
// kColSlots, bits 8-11) and its sum's workspace slot (bits 12 on).
// ops/symstore.py packs the same bits.
constexpr int kMetaRow = 0xF;
constexpr int kMetaTransposed = 1 << 4;
constexpr int kMetaColStart = 1 << 5;
constexpr int kMetaColEnd = 1 << 6;
constexpr int kMetaColWrite = 1 << 7;
constexpr int kMetaRingShift = 8;
constexpr int kMetaSlotShift = 12;

// The plan on the card: entries in walk order; units int4 {e0, e1, r0, 0}
// (entries [e0, e1), first row block r0), in launch order; fslots (units,
// kUnitRows): the slot of each unit row's sum, -1 for a row with no tile;
// the reduction's slot lists, output block j's slots red_slots[red_off[j]
// .. red_off[j + 1]) in the order they are summed.
struct Plan {
  const int4* entries;
  const int4* units;
  const int* fslots;
  int n_units;
  const int* red_off;
  const int* red_slots;
  int n_slots;
};

// shared memory of the unit kernel: 1024-byte-aligned stages, the unit's
// row blocks of u, the column ring of u, then the barriers
template <typename S, int NK>
struct UnitLayout {
  static constexpr int kRowBytes = kT * (int)sizeof(S);
  static constexpr int kBoxes = kRowBytes / 128;     // boxes a stage
  static constexpr int kStage = kT * kRowBytes;      // a half-tile
  static constexpr int kUPitch = bf16mma::UBlock<kT>::kPitch;
  static constexpr int kUBlock = 8 * NK * kUPitch;
  static constexpr int kURows = kUnitRows * kUBlock;
  static constexpr int kUCols = kColSlots * kUBlock;
  static constexpr int kBarriers = 256;  // full[kCount], rfull, released[]
  static constexpr int kFit =
      (kSmemBudget - 1024 - kURows - kUCols - kBarriers) / kStage;
  static constexpr int kCount = kFit > kMaxStages ? kMaxStages : kFit;
  static constexpr int kSmem =
      1024 + kCount * kStage + kURows + kUCols + kBarriers;
  static_assert(kFit >= 4, "fewer than 4 stages fit");
  static_assert(kCount <= kColSlots, "a column's u block could be reused");
};

template <int NK>
__device__ __forceinline__ void zero_f32(float (&a)[NK][4]) {
#pragma unroll
  for (int nk = 0; nk < NK; ++nk)
    a[nk][0] = a[nk][1] = a[nk][2] = a[nk][3] = 0.f;
}

template <int NK>
__device__ __forceinline__ void zero_f64(double (&a)[NK][4]) {
#pragma unroll
  for (int nk = 0; nk < NK; ++nk)
    a[nk][0] = a[nk][1] = a[nk][2] = a[nk][3] = 0.0;
}

template <int NK>
__device__ __forceinline__ void add_f64(double (&acc)[NK][4],
                                        const float (&p)[NK][4]) {
#pragma unroll
  for (int nk = 0; nk < NK; ++nk)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nk][q] += (double)p[nk][q];
}

// fwd[i] += p for the block-uniform row i: a chain of uniform branches,
// so every sum keeps a static register index
template <int I, int NK>
__device__ __forceinline__ void add_row(double (&fwd)[kUnitRows][NK][4],
                                        int i, const float (&p)[NK][4]) {
  if constexpr (I < kUnitRows) {
    if (i == I)
      add_f64(fwd[I], p);
    else
      add_row<I + 1, NK>(fwd, i, p);
  }
}

// One partial (a row's or a column's f64 sums, in the accumulators' thread
// layout) into slot `slot` of the workspace: [slot][half][candidate < Kg]
// [position < t], candidates >= Kb not written. Warp w holds positions
// 16 w .. 16 w + 15: the accumulators' rows g and g + 8 are positions
// 2g and 2g + 1 at int8, g and g + 8 at bf16 (bf16_mma.cuh).
template <bool kCodes, int NK>
__device__ __forceinline__ void store_partial(const double (&acc)[NK][4],
                                              double* ws, int slot, int h,
                                              int Kb, int Kg, int warp,
                                              int lane) {
  const int g = lane >> 2, tig = lane & 3;
  double* base = ws + ((size_t)slot * 2 + h) * Kg * kT + 16 * warp;
#pragma unroll
  for (int nk = 0; nk < NK; ++nk)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * nk + 2 * tig + e;
      if (n >= Kb) continue;
      double* row = base + (size_t)n * kT;
      if constexpr (kCodes) {
        *reinterpret_cast<double2*>(row + 2 * g) =
            make_double2(acc[nk][e], acc[nk][2 + e]);
      } else {
        row[g] = acc[nk][e];
        row[g + 8] = acc[nk][2 + e];
      }
    }
}

// Entry `en` of the walk into stage s, by one whole warp: its half-tile
// (2-D tensor-map copies by lane 0) and, at a column's first entry, the
// column's block of u (bulk copies, a candidate a lane) into its ring
// slot, all completing on full[s]. The caller knows the stage free: every
// warp has released its previous entry. The column's ring slot is free
// too: its previous column ended at least kColSlots >= kCount entries
// earlier.
template <typename S, int NK>
__device__ __forceinline__ void fill_stage(const int4& en, int s, int h,
                                            int Kb, int m,
                                            const CUtensorMap* store,
                                            const __nv_bfloat16* u,
                                            uint8_t* stages, uint8_t* ucols,
                                            uint64_t* full, int lane) {
  using L = UnitLayout<S, NK>;
  const bool col = en.w & kMetaColStart;
  if (lane == 0) {
    // the stage was last read by ldmatrix (the generic proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(&full[s], L::kStage + (col ? Kb * 2 * kT : 0));
    for (int bx = 0; bx < L::kBoxes; ++bx)
      tma_load_2d(stages + s * L::kStage + bx * kT * 128, store,
                  en.x + bx * (128 / (int)sizeof(S)), en.y + h * kT,
                  &full[s]);
  }
  __syncwarp();
  if (col) {
    const int q = (en.w >> kMetaRingShift) & 0xF;
    for (int n = lane; n < Kb; n += 32)
      bulk_copy(ucols + q * L::kUBlock + n * L::kUPitch,
                u + (size_t)n * m + (size_t)en.z * kT, 2 * kT, &full[s]);
  }
}

// Grid (units, 2 halves, groups of 16 candidates). S: int8 codes or bf16;
// NK: n8 groups of candidates (Kb <= 8 NK). The block's unit comes from the
// plan; the stages hold half h of each of its tiles.
template <typename S, int NK>
__global__ void __launch_bounds__(kUnitThreads, 1) sym_unit_kernel(
    const __grid_constant__ CUtensorMap store, Plan plan,
    const __nv_bfloat16* __restrict__ U, double* __restrict__ ws, int K,
    int Kg, int m, long long ws_group) {
  using L = UnitLayout<S, NK>;
  constexpr bool kCodes = sizeof(S) == 1;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* urows = smem + L::kCount * L::kStage;
  uint8_t* ucols = urows + L::kURows;
  uint64_t* full = reinterpret_cast<uint64_t*>(ucols + L::kUCols);
  uint64_t* rfull = full + L::kCount;
  unsigned* released = reinterpret_cast<unsigned*>(rfull + 1);

  const int4 unit = plan.units[blockIdx.x];
  const int* fs = plan.fslots + (size_t)blockIdx.x * kUnitRows;
  const int n_ent = unit.y - unit.x;
  const int4* ent = plan.entries + unit.x;
  const int h = blockIdx.y;
  const int k0 = blockIdx.z * kMaxK;
  const int Kb = min(kMaxK, K - k0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* u = U + (size_t)k0 * m;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kCount; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    mbar_init(rfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // candidate rows Kb .. 8 NK - 1 of every u block (row blocks and column
  // ring, one after the other) read as zero; no copy writes them
  {
    constexpr int kWords = 2 * kT / 4;  // a row's 32-bit words
    const int per = (8 * NK - Kb) * kWords;
    for (int w = threadIdx.x; w < (kUnitRows + kColSlots) * per;
         w += kUnitThreads) {
      const int blk = w / per, r = w % per;
      reinterpret_cast<uint32_t*>(urows + blk * L::kUBlock +
                                  (Kb + r / kWords) * L::kUPitch)[r % kWords] =
          0u;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // the unit's row blocks of u, once, and the first kCount entries
    int n_rows = 0;
    for (int i = 0; i < kUnitRows; ++i) n_rows += fs[i] >= 0;
    if (lane == 0) mbar_expect_tx(rfull, n_rows * Kb * 2 * kT);
    __syncwarp();
    for (int i = 0; i < kUnitRows; ++i) {
      if (fs[i] < 0) continue;
      for (int n = lane; n < Kb; n += 32)
        bulk_copy(urows + i * L::kUBlock + n * L::kUPitch,
                  u + (size_t)n * m + (size_t)(unit.z + i) * kT, 2 * kT,
                  rfull);
    }
    for (int it = 0; it < L::kCount && it < n_ent; ++it)
      fill_stage<S, NK>(ent[it], it, h, Kb, m, &store, u, smem, ucols, full,
                         lane);
  }

  double* wsb = ws + blockIdx.z * ws_group;
  double fwd[kUnitRows][NK][4], col[NK][4];
#pragma unroll
  for (int i = 0; i < kUnitRows; ++i) zero_f64(fwd[i]);
  zero_f64(col);
  const uint32_t stages = smem_u32(smem);
  const uint32_t ur0 = smem_u32(urows);
  const uint32_t uc0 = smem_u32(ucols);
  // the column's block of u as forward fragments, loaded at its first tile
  uint32_t ub[kT / 16][NK][2];
  int4 cur = ent[0];  // the entry, loaded one iteration ahead
  mbar_wait(rfull, 0);
  for (int it = 0; it < n_ent; ++it) {
    const int meta = cur.w;
    if (it + 1 < n_ent) cur = ent[it + 1];
    const bool refill = it + L::kCount < n_ent;
    int4 ahead = make_int4(0, 0, 0, 0);
    if (refill) ahead = ent[it + L::kCount];  // loaded early, used late
    const int i = meta & kMetaRow;
    const int s = it % L::kCount;
    mbar_wait(&full[s], (it / L::kCount) & 1);
    const uint32_t stage = stages + s * L::kStage;
    if (meta & kMetaColStart)
      bf16mma::load_forward_u<S, kT, NK>(
          ub, uc0 + ((meta >> kMetaRingShift) & 0xF) * L::kUBlock, lane);
    // both products in one basic block, so their steps interleave; a
    // diagonal tile's transposed product is taken and dropped
    float pf[NK][4], pt[NK][4];
    zero_f32(pf);
    zero_f32(pt);
    bf16mma::forward_regs<S, kT, NK, kT, true>(pf, stage, 16 * warp, ub,
                                               lane);
    bf16mma::transposed<S, kT, NK, kT, true>(pt, stage, 16 * warp,
                                             ur0 + i * L::kUBlock, lane);
    // release the stage (every read of it has returned: the products used
    // them); the last warp to release it refills it, below
    __syncwarp();
    unsigned last = 0;
    if (lane == 0) last = (atomicAdd(&released[s], 1u) + 1) % kWarps == 0;
    add_row<0, NK>(fwd, i, pf);
    if (meta & kMetaTransposed) add_f64(col, pt);
    if (meta & kMetaColEnd) {
      if (meta & kMetaColWrite)
        store_partial<kCodes, NK>(col, wsb, meta >> kMetaSlotShift, h, Kb,
                                  Kg, warp, lane);
      zero_f64(col);
    }
    if (__shfl_sync(0xffffffffu, last, 0) && refill)
      fill_stage<S, NK>(ahead, s, h, Kb, m, &store, u, smem, ucols, full,
                         lane);
  }
#pragma unroll
  for (int i = 0; i < kUnitRows; ++i)
    if (fs[i] >= 0)
      store_partial<kCodes, NK>(fwd[i], wsb, fs[i], h, Kb, Kg, warp, lane);
}

// Grid (nt, 2 halves, groups of 16 candidates): output block j of half h
// is the sum of its slots, in the plan's order, in f64; then rounded once
// to f32 and scaled (raw = 0) or written as it is (raw = 1). An output
// block with no slot is 0.
__global__ void __launch_bounds__(kThreads) sym_reduce_kernel(
    const double* __restrict__ ws, const int* __restrict__ red_off,
    const int* __restrict__ red_slots, void* __restrict__ out, int K, int Kg,
    int m, long long ws_group, int raw, float scale) {
  constexpr int kPer = kMaxK * kT / kThreads;
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int k0 = blockIdx.z * kMaxK;
  const int n_el = min(kMaxK, K - k0) * kT;
  const double* wsb = ws + blockIdx.z * ws_group;
  double acc[kPer];
#pragma unroll
  for (int v = 0; v < kPer; ++v) acc[v] = 0.0;
  for (int q = red_off[j]; q < red_off[j + 1]; ++q) {
    const double* p = wsb + ((size_t)red_slots[q] * 2 + h) * Kg * kT;
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int e = threadIdx.x + v * kThreads;
      if (e < n_el) acc[v] += __ldcs(p + e);
    }
  }
#pragma unroll
  for (int v = 0; v < kPer; ++v) {
    const int e = threadIdx.x + v * kThreads;
    if (e >= n_el) continue;
    const size_t at = (size_t)(k0 + e / kT) * 2 * m + (size_t)h * m +
                      (size_t)j * kT + (e % kT);
    if (raw)
      static_cast<double*>(out)[at] = acc[v];
    else
      static_cast<float*>(out)[at] = (float)acc[v] * scale;
  }
}

template <typename S, int NK>
cudaError_t launch_unit_kernel(const CUtensorMap& map, const Plan& plan,
                               const void* U, void* ws, int K, int Kg, int m,
                               long long ws_group, cudaStream_t stream) {
  using L = UnitLayout<S, NK>;
  const cudaError_t err = cudaFuncSetAttribute(
      sym_unit_kernel<S, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.n_units, 2, (K + kMaxK - 1) / kMaxK);
  sym_unit_kernel<S, NK><<<grid, kUnitThreads, L::kSmem, stream>>>(
      map, plan, (const __nv_bfloat16*)U, (double*)ws, K, Kg, m, ws_group);
  return cudaGetLastError();
}

// Both passes of one call over storage of S viewed as `rows` x `cols`
// (row-major, 16-byte aligned), with the plan's arrays (see Plan): the unit
// kernel, then the reduction, on the caller's stream. ws holds groups x
// n_slots x 2 x Kg x t doubles, Kg = min(K, 16), a group for each 16
// candidates.
template <typename S>
int launch_units(const void* storage, long long rows, long long cols,
                 const void* entries, const void* units, const void* fslots,
                 int n_units, const void* red_off, const void* red_slots,
                 int n_slots, const void* U, void* out, void* ws, int K,
                 int nt, int t, int raw, float scale, void* stream) {
  const Plan plan{(const int4*)entries, (const int4*)units,
                  (const int*)fslots,   n_units,
                  (const int*)red_off,  (const int*)red_slots,
                  n_slots};
  if (K < 1 || nt < 1 || t != kT || plan.n_units < 0 ||
      (K + kMaxK - 1) / kMaxK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int m = nt * kT;
  const int Kg = K < kMaxK ? K : kMaxK;
  const long long ws_group = (long long)plan.n_slots * 2 * Kg * kT;
  if (plan.n_units > 0) {
    CUtensorMap map;
    cudaError_t err = storage_map<S>(&map, storage, rows, cols, kT);
    if (err != cudaSuccess) return (int)err;
    err = Kg <= 8 ? launch_unit_kernel<S, 1>(map, plan, U, ws, K, Kg, m,
                                             ws_group, st)
                  : launch_unit_kernel<S, 2>(map, plan, U, ws, K, Kg, m,
                                             ws_group, st);
    if (err != cudaSuccess) return (int)err;
  }
  sym_reduce_kernel<<<dim3(nt, 2, (K + kMaxK - 1) / kMaxK), kThreads, 0,
                      st>>>((const double*)ws, plan.red_off, plan.red_slots,
                            out, K, Kg, m, ws_group, raw, scale);
  return (int)cudaGetLastError();
}

// float / double tiles: output column o (of 2t) of one tile, with global
// row stride ld elements, applied to u's block ub, added to acc[0:K].
template <typename F>
__device__ __forceinline__ void apply_tile_float(double (&acc)[kMaxK],
                                                 const F* tile, size_t ld,
                                                 const F* U, int K, int m,
                                                 int t, int o, bool fwd,
                                                 int ub) {
  const F* u = U + (size_t)ub * t;
  if (fwd) {
    const F* row = tile + (size_t)o * ld;
    for (int q = 0; q < t; ++q) {
      const F s = row[q];
      if (s == F(0)) continue;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k] += (double)s * (double)u[(size_t)k * m + q];
    }
  } else {
    const int h = o / t;
    const F* col = tile + (size_t)(h * t) * ld + (o % t);
    for (int i = 0; i < t; ++i) {
      const F s = col[(size_t)i * ld];
      if (s == F(0)) continue;
#pragma unroll
      for (int k = 0; k < kMaxK; ++k)
        if (k < K) acc[k] += (double)s * (double)u[(size_t)k * m + i];
    }
  }
}

// output column o of block j: f32 after one rounding, or the raw f64 sums
__device__ __forceinline__ void store_float(const double (&acc)[kMaxK],
                                            void* out, int raw, int K, int m,
                                            int t, int j, int o) {
  const size_t col = (size_t)(o / t) * m + (size_t)j * t + (o % t);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k >= K) continue;
    const size_t at = (size_t)k * 2 * m + col;
    if (raw)
      static_cast<double*>(out)[at] = acc[k];
    else
      static_cast<float*>(out)[at] = (float)acc[k];
  }
}

}  // namespace symtile
