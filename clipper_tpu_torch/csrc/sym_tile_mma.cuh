// The design shared by the two symmetric-triangle dual matvecs,
// sym_rows_matvec.cu (row-chunked storage) and sym_tiles_matvec.cu (the
// tile list). Both apply stored (2t, t) [M; C] tiles to the K candidate
// rows U (K, m): tile (r, c) forward (its rows are outputs: block r) and,
// off the diagonal, transposed (its columns are outputs: block c). For
// int8 and bf16 tiles the two layouts differ only in where a tile sits,
// and the host's plan (ops/symstore.unit_plan) says that, so one kernel
// serves both.
//
// Routes by tile (ops/symstore.matvec_route picks one in the wrappers and
// counts its launches under its own key):
//   "units" int8 / bf16 at t a multiple of 16: the tensor-core design
//           below, on the matrix's 128-row tiles (kT). Where 128 divides
//           t, a stored t-tile (r, c) is the (t / 128)^2 tiles (r q + a,
//           c q + b) of the 128-grid, q = t / 128 (on a diagonal t-tile
//           the upper ones, a <= b, whose a < b tiles the kernel also
//           applies transposed), each at its own place in the storage,
//           its C half t rows below its M half: the plan holds them
//           (symstore.unit_plan over the 128-grid) and the kernel reads
//           them as at t = 128 (kP = 1). Elsewhere (t = 16, 32, 48, 64,
//           96, ...) an entry is a super-tile of 128 rows of the matrix
//           made of the storage's kG-row tiles, kG the largest of 64, 32
//           and 16 dividing t (kP = 128 / kG of them a side, Sub below):
//           kP^2 tensor-map boxes of (kG rows, kG elements) with the
//           swizzle of that width land in the stage as its 128-row column
//           boxes, so the products, sums and numerics are t = 128's. A
//           diagonal super-tile's diagonal sub-tiles hold full symmetric
//           blocks: its transposed product zeroes their rows
//           (bf16mma::transposed's row mask). Each stored byte leaves
//           device memory once: the boxes are each tile's own rows.
//   "core"  int8 / bf16 at every other t >= 1 dividing m, and "float",
//           f32 / f64 at every t: the CUDA-core kernel of sym_core.cuh,
//           on the same plan and reduction over the t-grid.
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
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "hopper_copy.cuh"

namespace symtile {

using namespace hopper;

constexpr int kT = 128;             // the tensor-core kernels' tile (a
                                    // stored tile of any multiple of it
                                    // is read as kT-tiles)
constexpr int kThreads = 256;       // the reduction kernel
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

// A plan entry is one kT-tile, int4 {x, y, c, meta}: its element column
// and row in the storage's 2-D view (rows of its M half; the C half is the
// stored tile's t rows below), its column block c in the kT-grid, and
// meta: the unit row i (bits 0-3), whether it is applied transposed
// (r != c), whether it starts or ends its column in the unit, whether
// the column's sum is written at its end, the column's slot in the ring
// of u blocks (its ordinal in the unit modulo kColSlots, bits 8-11) and
// its sum's workspace slot (bits 12 on).
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

// The sub-tiled walk (t a multiple of 16 but not of kT): each plan entry
// is a kT-tile of the matrix (a super-tile), which the storage holds as
// kP x kP tiles of kG = kT / kP rows (kG the largest of 64, 32, 16
// dividing t; ops/symstore.unit_tile), each at its own place. Entry.x
// indexes subs, kP * kP int2 {x, y} a super-tile, sub-tile (a, b) (rows
// a kG.., columns b kG..) at a * kP + b: its M half's element column and
// row in the storage's 2-D view (the C half the stored tile's t rows
// below). A sub-tile the storage does not hold (below the diagonal, past
// m, or outside a slice) points past the view's last row: its box is out
// of bounds, so the copy writes zeros. On a diagonal super-tile the
// diagonal sub-tiles (a == b) hold their full symmetric blocks: they are
// applied forward only, and the transposed product leaves their rows out.
template <int kP>
struct Sub {
  static constexpr int kG = kT / kP;  // a sub-tile's rows
  static constexpr int kPer = (kP * kP + 31) / 32;  // sub-tiles a lane
};

// the sub-tiles lane copies of entry en (lane + 32 j), from the plan's subs
template <int kP>
__device__ __forceinline__ void load_subs(int2 (&xy)[Sub<kP>::kPer],
                                          const int2* subs, const int4& en,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < Sub<kP>::kPer; ++j) {
    const int q = lane + 32 * j;
    xy[j] = q < kP * kP ? subs[(size_t)en.x * kP * kP + q] : make_int2(0, 0);
  }
}

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
// (the C half `half` rows, the stored tile's t, below the M half)
// (2-D tensor-map copies by lane 0; at kP > 1 the kP^2 sub-tile boxes of
// the super-tile, by the warp's lanes, each into its rows and column box
// of the stage) and, at a column's first entry, the column's block of u
// (bulk copies, a candidate a lane; at kP > 1 only its positions below
// m) into its ring slot, all completing on full[s]. The caller knows the
// stage free: every warp has released its previous entry. The column's
// ring slot is free too: its previous column ended at least kColSlots >=
// kCount entries earlier.
template <typename S, int NK, int kP>
__device__ __forceinline__ void fill_stage(const int4& en, int s, int h,
                                            int half, int Kb, int m,
                                            const CUtensorMap* store,
                                            const int2 (&xy)[Sub<kP>::kPer],
                                            const __nv_bfloat16* u,
                                            uint8_t* stages, uint8_t* ucols,
                                            uint64_t* full, int lane) {
  using L = UnitLayout<S, NK>;
  const bool col = en.w & kMetaColStart;
  if constexpr (kP == 1) {
    if (lane == 0) {
      // the stage was last read by ldmatrix (the generic proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(&full[s], L::kStage + (col ? Kb * 2 * kT : 0));
      for (int bx = 0; bx < L::kBoxes; ++bx)
        tma_load_2d(stages + s * L::kStage + bx * kT * 128, store,
                    en.x + bx * (128 / (int)sizeof(S)), en.y + h * half,
                    &full[s]);
    }
    __syncwarp();
    if (col) {
      const int q = (en.w >> kMetaRingShift) & 0xF;
      for (int n = lane; n < Kb; n += 32)
        bulk_copy(ucols + q * L::kUBlock + n * L::kUPitch,
                  u + (size_t)n * m + (size_t)en.z * kT, 2 * kT, &full[s]);
    }
  } else {
    constexpr int kG = Sub<kP>::kG;
    constexpr int kBW = kG * (int)sizeof(S);  // a box row's bytes
    const int ulen = min(kT, m - en.z * kT);  // the column's positions < m
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0)
      mbar_expect_tx(&full[s], L::kStage + (col ? Kb * 2 * ulen : 0));
    __syncwarp();
#pragma unroll
    for (int j = 0; j < Sub<kP>::kPer; ++j) {
      const int q = lane + 32 * j;
      if (q < kP * kP)
        tma_load_2d(stages + s * L::kStage + (q % kP) * kT * kBW +
                        (q / kP) * kG * kBW,
                    store, xy[j].x, xy[j].y + h * half, &full[s]);
    }
    if (col) {
      const int q = (en.w >> kMetaRingShift) & 0xF;
      for (int n = lane; n < Kb; n += 32)
        bulk_copy(ucols + q * L::kUBlock + n * L::kUPitch,
                  u + (size_t)n * m + (size_t)en.z * kT, 2 * ulen, &full[s]);
    }
  }
}

// Grid (units, 2 halves, groups of 16 candidates). S: int8 codes or bf16;
// NK: n8 groups of candidates (Kb <= 8 NK); kP: sub-tiles a side of an
// entry (1: the storage's own kT-tiles; else Sub<kP>, with subs); half:
// the stored tile's t, the rows from a tile's M half to its C half. The
// block's unit comes from the plan; the stages hold half h of each of its
// tiles.
template <typename S, int NK, int kP>
__global__ void __launch_bounds__(kUnitThreads, 1) sym_unit_kernel(
    const __grid_constant__ CUtensorMap store, Plan plan,
    const int2* __restrict__ subs, const __nv_bfloat16* __restrict__ U,
    double* __restrict__ ws, int K, int Kg, int m, int half,
    long long ws_group) {
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
  if constexpr (kP == 1) {
    constexpr int kWords = 2 * kT / 4;  // a row's 32-bit words
    const int per = (8 * NK - Kb) * kWords;
    for (int w = threadIdx.x; w < (kUnitRows + kColSlots) * per;
         w += kUnitThreads) {
      const int blk = w / per, r = w % per;
      reinterpret_cast<uint32_t*>(urows + blk * L::kUBlock +
                                  (Kb + r / kWords) * L::kUPitch)[r % kWords] =
          0u;
    }
  } else {
    // and so do the positions past m of a last, short block of u, whose
    // copies stop at m: every u block starts as zeros (a slot's later
    // copies leave finite values there, which meet zero tiles)
    for (int w = threadIdx.x; w < (L::kURows + L::kUCols) / 16;
         w += kUnitThreads)
      reinterpret_cast<uint4*>(urows)[w] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  if (warp == 0) {
    // the unit's row blocks of u, once, and the first kCount entries
    int n_rows = 0;
    for (int i = 0; i < kUnitRows; ++i) n_rows += fs[i] >= 0;
    if constexpr (kP == 1) {
      if (lane == 0) mbar_expect_tx(rfull, n_rows * Kb * 2 * kT);
      __syncwarp();
      for (int i = 0; i < kUnitRows; ++i) {
        if (fs[i] < 0) continue;
        for (int n = lane; n < Kb; n += 32)
          bulk_copy(urows + i * L::kUBlock + n * L::kUPitch,
                    u + (size_t)n * m + (size_t)(unit.z + i) * kT, 2 * kT,
                    rfull);
      }
    } else {
      // a row block's positions below m
      int n_pos = 0;
      for (int i = 0; i < kUnitRows; ++i)
        if (fs[i] >= 0) n_pos += min(kT, m - (unit.z + i) * kT);
      if (lane == 0) mbar_expect_tx(rfull, n_pos * Kb * 2);
      __syncwarp();
      for (int i = 0; i < kUnitRows; ++i) {
        if (fs[i] < 0) continue;
        const int len = min(kT, m - (unit.z + i) * kT);
        for (int n = lane; n < Kb; n += 32)
          bulk_copy(urows + i * L::kUBlock + n * L::kUPitch,
                    u + (size_t)n * m + (size_t)(unit.z + i) * kT, 2 * len,
                    rfull);
      }
    }
    for (int it = 0; it < L::kCount && it < n_ent; ++it) {
      const int4 en = ent[it];
      int2 xy[Sub<kP>::kPer];
      if constexpr (kP > 1) load_subs<kP>(xy, subs, en, lane);
      fill_stage<S, NK, kP>(en, it, h, half, Kb, m, &store, xy, u, smem,
                            ucols, full, lane);
    }
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
  // at kP > 1, the entry kCount ahead, loaded an iteration before its
  // sub-tiles are (so that their load waits on nothing)
  int4 next = make_int4(0, 0, 0, 0);
  if constexpr (kP > 1)
    if (L::kCount < n_ent) next = ent[L::kCount];
  mbar_wait(rfull, 0);
  for (int it = 0; it < n_ent; ++it) {
    const int meta = cur.w;
    const int cb = cur.z;  // the entry's column block
    if (it + 1 < n_ent) cur = ent[it + 1];
    const bool refill = it + L::kCount < n_ent;
    int4 ahead = make_int4(0, 0, 0, 0);
    int2 axy[Sub<kP>::kPer];
    if constexpr (kP == 1) {
      if (refill) ahead = ent[it + L::kCount];  // loaded early, used late
    } else {
      ahead = next;
      if (it + 1 + L::kCount < n_ent) next = ent[it + 1 + L::kCount];
      if (refill) load_subs<kP>(axy, subs, ahead, lane);
    }
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
    if constexpr (kP == 1) {
      bf16mma::forward_regs<S, kT, NK, kT, true>(pf, stage, 16 * warp, ub,
                                                 lane);
      bf16mma::transposed<S, kT, NK, kT, true>(pt, stage, 16 * warp,
                                               ur0 + i * L::kUBlock, lane);
    } else {
      constexpr int kG = Sub<kP>::kG;
      constexpr int kBW = kG * (int)sizeof(S);
      bf16mma::forward_regs<S, kT, NK, kT, true, kBW>(pf, stage, 16 * warp,
                                                      ub, lane);
      if (unit.z + i == cb) {
        // a diagonal super-tile: the transposed product leaves out the
        // rows of the warp's own diagonal sub-tile
        const int lo = 16 * warp / kG * kG;
        bf16mma::transposed<S, kT, NK, kT, true, kBW, true>(
            pt, stage, 16 * warp, ur0 + i * L::kUBlock, lane, lo, lo + kG);
      } else {
        bf16mma::transposed<S, kT, NK, kT, true, kBW>(
            pt, stage, 16 * warp, ur0 + i * L::kUBlock, lane);
      }
    }
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
      fill_stage<S, NK, kP>(ahead, s, h, half, Kb, m, &store, axy, u, smem,
                            ucols, full, lane);
  }
#pragma unroll
  for (int i = 0; i < kUnitRows; ++i)
    if (fs[i] >= 0)
      store_partial<kCodes, NK>(fwd[i], wsb, fs[i], h, Kb, Kg, warp, lane);
}

// Grid (output blocks of bw positions, 2 halves, groups of `group`
// candidates), both routes' reduction: bw = kT and group = kMaxK after
// the unit kernel, bw = t and group = symcore::core_group(t) after the
// CUDA-core kernel (sym_core.cuh). Output block j of half h is the sum of
// its slots, in the plan's order, in f64; then rounded once to f32 and
// scaled (raw = 0) or written as it is (raw = 1). An output block with no
// slot is 0; positions past m are not written. A thread keeps kPer sums in
// registers, so its loads of one slot are independent.
__global__ void __launch_bounds__(kThreads) sym_reduce_kernel(
    const double* __restrict__ ws, const int* __restrict__ red_off,
    const int* __restrict__ red_slots, void* __restrict__ out, int K,
    int group, int bw, int m, long long ws_group, int raw, float scale) {
  constexpr int kPer = kMaxK * kT / kThreads;
  const int j = blockIdx.x;
  const int h = blockIdx.y;
  const int k0 = blockIdx.z * group;
  const int Kg = min(K, group);
  const int n_el = min(group, K - k0) * bw;
  const double* wsb = ws + blockIdx.z * ws_group;
  for (int e0 = 0; e0 < n_el; e0 += kPer * kThreads) {
    double acc[kPer];
#pragma unroll
    for (int v = 0; v < kPer; ++v) acc[v] = 0.0;
    for (int q = red_off[j]; q < red_off[j + 1]; ++q) {
      const double* p = wsb + ((size_t)red_slots[q] * 2 + h) * Kg * bw;
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int e = e0 + threadIdx.x + v * kThreads;
        if (e < n_el) acc[v] += __ldcs(p + e);
      }
    }
#pragma unroll
    for (int v = 0; v < kPer; ++v) {
      const int e = e0 + threadIdx.x + v * kThreads;
      if (e >= n_el || j * bw + e % bw >= m) continue;
      const size_t at = (size_t)(k0 + e / bw) * 2 * m + (size_t)h * m +
                        (size_t)j * bw + (e % bw);
      if (raw)
        static_cast<double*>(out)[at] = acc[v];
      else
        static_cast<float*>(out)[at] = (float)acc[v] * scale;
    }
  }
}

template <typename S, int NK, int kP>
cudaError_t launch_unit_kernel(const CUtensorMap& map, const Plan& plan,
                               const void* subs, const void* U, void* ws,
                               int K, int Kg, int m, int half,
                               long long ws_group, cudaStream_t stream) {
  using L = UnitLayout<S, NK>;
  const cudaError_t err = cudaFuncSetAttribute(
      sym_unit_kernel<S, NK, kP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.n_units, 2, (K + kMaxK - 1) / kMaxK);
  sym_unit_kernel<S, NK, kP><<<grid, kUnitThreads, L::kSmem, stream>>>(
      map, plan, (const int2*)subs, (const __nv_bfloat16*)U, (double*)ws, K,
      Kg, m, half, ws_group);
  return cudaGetLastError();
}

// the unit kernel at kP sub-tiles a side, by the candidates' n8 groups
template <typename S, int kP>
cudaError_t launch_unit_nk(const CUtensorMap& map, const Plan& plan,
                           const void* subs, const void* U, void* ws, int K,
                           int Kg, int m, int half, long long ws_group,
                           cudaStream_t st) {
  return Kg <= 8 ? launch_unit_kernel<S, 1, kP>(map, plan, subs, U, ws, K,
                                                Kg, m, half, ws_group, st)
                 : launch_unit_kernel<S, 2, kP>(map, plan, subs, U, ws, K,
                                                Kg, m, half, ws_group, st);
}

// Both passes of one call over storage of S viewed as `rows` x `cols`
// (row-major, 16-byte aligned) of nt stored t-tiles a side, t a multiple
// of 16 (route "units"), with the plan's arrays over the kT-grid (see
// Plan): the unit kernel, then the reduction, on the caller's stream. g:
// the plan's sub-tile (ops/symstore.unit_tile: kT itself when kT divides
// t, subs then unused; else 64, 32 or 16, with the plan's subs, see Sub).
// ws holds groups x n_slots x 2 x Kg x kT doubles, Kg = min(K, 16), a
// group for each 16 candidates.
template <typename S>
int launch_units(const void* storage, long long rows, long long cols,
                 const void* entries, const void* units, const void* fslots,
                 int n_units, const void* red_off, const void* red_slots,
                 int n_slots, const void* subs, int g, const void* U,
                 void* out, void* ws, int K, int nt, int t, int raw,
                 float scale, void* stream) {
  const Plan plan{(const int4*)entries, (const int4*)units,
                  (const int*)fslots,   n_units,
                  (const int*)red_off,  (const int*)red_slots,
                  n_slots};
  const bool sub_ok = g == kT || ((g == 64 || g == 32 || g == 16) &&
                                  subs != nullptr && t % 16 == 0);
  if (K < 1 || nt < 1 || t < 16 || t % g || !sub_ok || plan.n_units < 0 ||
      (K + kMaxK - 1) / kMaxK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int m = nt * t;
  const int ntk = (m + kT - 1) / kT;  // output blocks of the kT-grid
  const int Kg = K < kMaxK ? K : kMaxK;
  const long long ws_group = (long long)plan.n_slots * 2 * Kg * kT;
  if (plan.n_units > 0) {
    CUtensorMap map;
    const int box = g < kT ? g * (int)sizeof(S) : 128;
    cudaError_t err = storage_map<S>(&map, storage, rows, cols, g, box);
    if (err != cudaSuccess) return (int)err;
    switch (g) {
      case kT:
        err = launch_unit_nk<S, 1>(map, plan, subs, U, ws, K, Kg, m, t,
                                   ws_group, st);
        break;
      case 64:
        err = launch_unit_nk<S, 2>(map, plan, subs, U, ws, K, Kg, m, t,
                                   ws_group, st);
        break;
      case 32:
        err = launch_unit_nk<S, 4>(map, plan, subs, U, ws, K, Kg, m, t,
                                   ws_group, st);
        break;
      default:
        err = launch_unit_nk<S, 8>(map, plan, subs, U, ws, K, Kg, m, t,
                                   ws_group, st);
    }
    if (err != cudaSuccess) return (int)err;
  }
  sym_reduce_kernel<<<dim3(ntk, 2, (K + kMaxK - 1) / kMaxK), kThreads, 0,
                      st>>>((const double*)ws, plan.red_off, plan.red_slots,
                            out, K, kMaxK, kT, m, ws_group, raw, scale);
  return (int)cudaGetLastError();
}

// a stored value or an operand as f64: int8 codes and bf16 values exactly
__device__ __forceinline__ double f64_of(int8_t x) { return (double)x; }
__device__ __forceinline__ double f64_of(__nv_bfloat16 x) {
  return (double)__bfloat162float(x);
}
__device__ __forceinline__ double f64_of(float x) { return (double)x; }
__device__ __forceinline__ double f64_of(double x) { return x; }

}  // namespace symtile
