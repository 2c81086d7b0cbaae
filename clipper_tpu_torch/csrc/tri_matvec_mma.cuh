// Kernel 1's one-read design over upper-triangle pool storage, for Hopper:
// the batched dual matvec of tri_matvec.cu (flat storage, K candidates a
// lane) and tri_tiles_matvec.cu (tile-major storage, one probe a lane).
// tri_matvec.cu's header comment sets out the design: one block per
// (half h, lane b) walks the lane's tiles in storage order, a producer
// warp copies each tile's half in 64-row panels through a ring of
// 128-byte-swizzled stages (tensor-map copies), eight consumer warps take
// both products of each staged panel by mma.sync and own their outputs
// outright, with no atomics.
//
// The two storage layouts hold the same tiles in the same order and
// differ only in where tile k's rows lie, so the address is a
// compile-time policy of the one kernel (Layout below): at one probe the
// two kernels run the same instructions in the same order, and kernel 9
// on the tile-major form of some content gives the bits of kernel 1 at
// K=1 on its flat form.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"

namespace {

using namespace hopper;
using bf16mma::forward_bf16;
using bf16mma::forward_i8;
using bf16mma::transposed_bf16;
using bf16mma::transposed_i8;

constexpr int kPanel = 64;                       // tile rows a stage holds
constexpr int kConsumers = 8;                    // warps applying panels
constexpr int kThreads = 32 * (kConsumers + 1);  // + the producer warp
constexpr int kSmemBytes = 113 * 1024;           // two blocks on an SM
constexpr int kMaxStages = 8;


// Where the copies find the rows of half h of problem q's tile k (its k-th
// in storage order; n = nt (nt + 1) / 2 tiles a problem) as (column x,
// row y) of the tensor map's 2-D view.
//   FlatTiles (kernel 1): the (P 2t, S) view of (P, 2t, S) storage: row
//     (q 2 + h) t, column k t;
//   TileMajor (kernel 9): the (P n 2t, t) view of (P, n, 2t, t) storage:
//     row ((q n + k) 2 + h) t, column 0.
struct FlatTiles {
  __device__ __forceinline__ static int2 origin(int q, int h, int k, int n,
                                                int t) {
    return make_int2(k * t, (q * 2 + h) * t);
  }
};

struct TileMajor {
  __device__ __forceinline__ static int2 origin(int q, int h, int k, int n,
                                                int t) {
    return make_int2(0, ((q * n + k) * 2 + h) * t);
  }
};

// The ring's layout. A stage holds kPanel rows of one half of a tile, as
// the tensor-map copy leaves them: 128-byte column boxes one after the
// other, each kPanel rows of 128 bytes with the 16-byte chunks of row r
// XORed with r % 8 (the 128-byte swizzle), so 8 consecutive rows at one
// column hit distinct banks. Beside the stages, two u slots each hold one
// tile's blocks of the candidates: u_c (forward) and u_r (transposed),
// 8 NK rows of T bf16 values (rows >= K zero), rows 16 bytes apart in the
// banks.
template <typename S, int T, int NK>
struct Ring {
  static constexpr int kRowBytes = T * (int)sizeof(S);
  static constexpr int kBoxes = kRowBytes / 128;
  static constexpr int kBytes = kPanel * kRowBytes;  // a multiple of 1024
  static constexpr int kUPitch = bf16mma::UBlock<T>::kPitch;
  static constexpr int kURows = 8 * NK;
  static constexpr int kUBlock = kURows * kUPitch;  // u_c or u_r
  static constexpr int kUSlots = 2 * 2 * kUBlock;   // two slots of both
  static constexpr int kBarriers = 256;             // room for the mbarriers
  static constexpr int kFit =
      (kSmemBytes - kBarriers - 1024 - kUSlots) / kBytes;
  static constexpr int kCount =
      kFit < 2 ? 2 : (kFit > kMaxStages ? kMaxStages : kFit);
  // + 1024: the stages' alignment (the swizzle repeats every 1024 bytes)
  static constexpr int kSmem = kCount * kBytes + kUSlots + kBarriers + 1024;
  static constexpr bool kCodes = sizeof(S) == 1;
};

template <int NK>
__device__ __forceinline__ void zero1(float (&acc)[NK][4]) {
#pragma unroll
  for (int nk = 0; nk < NK; ++nk)
    acc[nk][0] = acc[nk][1] = acc[nk][2] = acc[nk][3] = 0.f;
}

template <int F, int NK>
__device__ __forceinline__ void zero(float (&acc)[F][NK][4]) {
#pragma unroll
  for (int f = 0; f < F; ++f)
#pragma unroll
    for (int nk = 0; nk < NK; ++nk)
      acc[f][nk][0] = acc[f][nk][1] = acc[f][nk][2] = acc[f][nk][3] = 0.f;
}

// acc += part, rounded to nearest (see mma_add)
template <int NK>
__device__ __forceinline__ void add(float (&acc)[NK][4],
                                    const float (&part)[NK][4]) {
#pragma unroll
  for (int nk = 0; nk < NK; ++nk)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nk][q] += part[nk][q];
}

// One 16-row output block at column col of ob's (K, 2m) rows, in the
// accumulators' thread layout: load its raw sums, or store acc * scale.
// The int8 layout's rows g and g + 8 are adjacent outputs (2g, 2g + 1):
// one 8-byte access for the pair.
template <bool kCodes, int NK>
__device__ __forceinline__ void load_block(float (&acc)[NK][4],
                                           const float* ob, int K, int m,
                                           int col, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nk = 0; nk < NK; ++nk)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * nk + 2 * tig + e;
      const float* row = ob + (size_t)n * 2 * m + col;
      float2 v = make_float2(0.f, 0.f);
      if (n < K) {
        if constexpr (kCodes)
          v = *reinterpret_cast<const float2*>(row + 2 * g);
        else
          v = make_float2(row[g], row[g + 8]);
      }
      acc[nk][e] = v.x;
      acc[nk][2 + e] = v.y;
    }
}

template <bool kCodes, int NK>
__device__ __forceinline__ void store_block(float* ob,
                                            const float (&acc)[NK][4], int K,
                                            int m, int col, int lane,
                                            float scale) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nk = 0; nk < NK; ++nk)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * nk + 2 * tig + e;
      if (n >= K) continue;
      float* row = ob + (size_t)n * 2 * m + col;
      const float2 v =
          make_float2(acc[nk][e] * scale, acc[nk][2 + e] * scale);
      if constexpr (kCodes) {
        *reinterpret_cast<float2*>(row + 2 * g) = v;
      } else {
        row[g] = v.x;
        row[g + 8] = v.y;
      }
    }
}

// S: storage element (int8 codes or bf16); T: tile, a multiple of 128
// (128 to 512 are instantiated: F = T / 128 output blocks a warp, an even
// number of panels a tile, and at 512 the ring's two stages and u slots
// still fit one block an SM); NK: n8 column groups of candidates
// (K <= 8 NK); Layout: FlatTiles or TileMajor. Grid (2, B):
// blockIdx.x the half (0: M, 1: C), blockIdx.y the lane. Warp w < 8 owns
// the 16-row output blocks w + 8 f, f < F, of every t-block of its half's
// output row.
template <typename S, int T, int NK, typename Layout>
__global__ void __launch_bounds__(kThreads) tri_matvec_mma_kernel(
    const __grid_constant__ CUtensorMap tri, const int* __restrict__ idx,
    const __nv_bfloat16* __restrict__ U, float* __restrict__ out, int K,
    int nt, float scale) {
  using L = Ring<S, T, NK>;
  static_assert(T % 128 == 0 && L::kSmem <= 227 * 1024,
                "a tile the panels and the ring do not take");
  constexpr int NP = T / kPanel;  // panels a tile
  constexpr int F = T / 128;      // output blocks of 16 a warp owns
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* uslot = smem + L::kCount * L::kBytes;  // 2 x (u_c, u_r)
  uint64_t* full = reinterpret_cast<uint64_t*>(uslot + L::kUSlots);
  uint64_t* empty = full + L::kCount;
  uint64_t* ufull = empty + L::kCount;  // 2
  uint64_t* uempty = ufull + 2;         // 2

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = nt * T;
  const int total = nt * (nt + 1) / 2 * NP;  // panels of the walk

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kCount; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&ufull[s], 1);
      mbar_init(&uempty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // candidate rows K .. 8 NK - 1 of the u slots read as zero; no copy
  // writes them
  for (int i = threadIdx.x; i < 4 * (L::kURows - K) * (2 * T) / 4;
       i += kThreads) {
    const int per = (L::kURows - K) * (2 * T) / 4;  // words a block
    const int blk = i / per, w = i % per;
    const int row = K + w / (2 * T / 4), col = w % (2 * T / 4);
    reinterpret_cast<uint32_t*>(uslot + blk * L::kUBlock +
                                row * L::kUPitch)[col] = 0u;
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer: at a tile's first panel, the tile's u blocks into slot
    // tile % 2; panel `it` of the walk into stage it % kCount; each once
    // the slot's or stage's previous use has been released
    const int prob = idx[b];
    const int ntiles = nt * (nt + 1) / 2;
    const __nv_bfloat16* u = U + (size_t)b * K * m;
    int r = 0, c = 0, p = 0, tile = 0;
    for (int it = 0; it < total; ++it) {
      if (p == 0) {
        const int q = tile & 1;
        if (tile >= 2) mbar_wait(&uempty[q], (tile / 2 - 1) & 1);
        if (lane == 0) mbar_expect_tx(&ufull[q], 2 * K * 2 * T);
        __syncwarp();
        uint8_t* us = uslot + q * 2 * L::kUBlock;
        for (int i = lane; i < 2 * K; i += 32) {
          const int n = i % K, blk = i / K;  // blk 0: u_c, 1: u_r
          bulk_copy(us + blk * L::kUBlock + n * L::kUPitch,
                    u + (size_t)n * m + (blk ? r : c) * T, 2 * T, &ufull[q]);
        }
      }
      const int s = it % L::kCount;
      if (it >= L::kCount) mbar_wait(&empty[s], (it / L::kCount - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[s], kPanel * L::kRowBytes);
        const int2 o = Layout::origin(prob, h, tile, ntiles, T);
        for (int bx = 0; bx < L::kBoxes; ++bx)
          tma_load_2d(smem + s * L::kBytes + bx * kPanel * 128, &tri,
                      o.x + bx * (128 / (int)sizeof(S)), o.y + p * kPanel,
                      &full[s]);
      }
      __syncwarp();
      if (++p == NP) {
        p = 0;
        ++tile;
        if (++c == nt) c = ++r;
      }
    }
    return;
  }

  float* ob = out + (size_t)b * K * 2 * m + (size_t)h * m;
  float fwd[F][NK][4], tr[F][NK][4], base[F][NK][4];
  int it = 0, tile = 0;
  for (int r = 0; r < nt; ++r) {
    // block r's raw sums so far (the transposed products of rows < r),
    // loaded now so the loads' latency hides behind the row's tiles
#pragma unroll
    for (int f = 0; f < F; ++f) {
      if (r == 0)
        zero1(base[f]);
      else
        load_block<L::kCodes, NK>(base[f], ob, K, m,
                                  r * T + 16 * (warp + 8 * f), lane);
    }
    zero(fwd);
    for (int c = r; c < nt; ++c, ++tile) {
      const bool diag = c == r;  // complete in its forward product
      const int q = tile & 1;
      const uint32_t uc = smem_u32(uslot + q * 2 * L::kUBlock);
      const uint32_t ur = uc + L::kUBlock;
      // block c's raw sums, to which this tile's transposed product adds
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if (r == 0 || diag)
          zero1(tr[f]);
        else
          load_block<L::kCodes, NK>(tr[f], ob, K, m,
                                    c * T + 16 * (warp + 8 * f), lane);
      }
      mbar_wait(&ufull[q], (tile / 2) & 1);
#pragma unroll
      for (int p = 0; p < NP; ++p, ++it) {
        const int s = it % L::kCount;
        mbar_wait(&full[s], (it / L::kCount) & 1);
        const uint32_t stage = smem_u32(smem + s * L::kBytes);
        // panel p holds output blocks 4p..4p+3: warps 4 (p & 1) .. + 3
        if ((warp >> 2) == (p & 1)) {
          float part[NK][4];
          zero1(part);
          if constexpr (L::kCodes)
            forward_i8<T, NK, kPanel>(part, stage, 16 * (warp & 3), uc,
                                      lane);
          else
            forward_bf16<T, NK, kPanel>(part, stage, 16 * (warp & 3), uc,
                                        lane);
          add(fwd[p >> 1], part);
        }
        if (!diag) {
#pragma unroll
          for (int f = 0; f < F; ++f) {
            float part[NK][4];
            zero1(part);
            if constexpr (L::kCodes)
              transposed_i8<T, NK, kPanel>(part, stage, 16 * (warp + 8 * f),
                                           ur + 2 * p * kPanel, lane);
            else
              transposed_bf16<T, NK, kPanel>(part, stage,
                                             16 * (warp + 8 * f),
                                             ur + 2 * p * kPanel, lane);
            add(tr[f], part);
          }
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&empty[s]);
          if (p == NP - 1) mbar_arrive(&uempty[q]);
        }
      }
      if (!diag) {
#pragma unroll
        for (int f = 0; f < F; ++f)
          store_block<L::kCodes, NK>(ob, tr[f], K, m,
                                     c * T + 16 * (warp + 8 * f), lane, 1.f);
      }
    }
    // block r is complete: (its transposed sums + forward) * scale
#pragma unroll
    for (int f = 0; f < F; ++f) {
      add(base[f], fwd[f]);
      store_block<L::kCodes, NK>(ob, base[f], K, m,
                                 r * T + 16 * (warp + 8 * f), lane, scale);
    }
  }
}

// ---- Route "super": the kernel above at t = 128 over super-tiles.
//
// At a tile t that is a multiple of 16 but not one of the mma tiles, the
// walk is over the matrix's 128-row super-tiles (R, C), C >= R, R, C <
// ntS = ceil(m / 128), in row-major order, and the consumer is T = 128's:
// the same panels, fragments, products, f32 sums and output ownership. A
// super-tile's panel is assembled from boxes of the storage's kG-row
// stripes, kG the largest of 64, 32 and 16 dividing t (a stripe never
// straddles a t-block), each landing in its rows of the stage:
//   FlatSuper (kernel 1): a stripe of row block r holds that block's
//     stored columns [r t, m) side by side, so the stripe's 128 columns of
//     super-column C are one run of the row at column off_r t + 128 C - r t
//     of the (P 2t, S) view: sizeof(S) boxes of (kG rows, 128 bytes) with
//     the 128-byte swizzle. Their columns left of r t (the previous row
//     block's tiles) and past m (the next one's) are masked below;
//   TileSuper (kernel 9): tile-major tiles are t wide, so a stripe takes
//     128 / kG sub-tile boxes of (kG rows, kG elements), each from its own
//     tile, with the swizzle of kG elements' bytes (hopper::swizzle_of).
// A stripe (kernel 1) or sub-tile (kernel 9) that holds no stored element
// (its rows past m; below the t-diagonal; kernel 9: its columns past m)
// is a box past the view's last row, which the copy fills with zeros
// without reading memory. The roles are per element (i, j), r = i / t,
// c = j / t: c < r absent; c > r forward and transposed; c == r (the
// diagonal t-tile, complete in storage) forward only on a diagonal
// super-tile, where its mirror is read too, and forward and transposed on
// C > R, where t does not divide 128 and the t-tile straddles super-tiles:
// its mirror lies in the lower super-tile (C, R), which is not walked. On
// the 16-aligned fragments the roles are intervals, applied as masks by
// the consumer: a warp's 16 forward rows keep the columns [max(r t,
// 128 C), m), its 16 transposed columns the rows [128 R, c t) on a
// diagonal super-tile and [128 R, (c + 1) t) off it. Masked fragments
// are zero, so absent data meets zero whatever the stage holds, and
// kernels 1 and 9 run the same products in the same order: kernel 9 on the
// tile-major form of some content gives kernel 1's bits at K = 1.
// tests/test_torch_anytile.py walks the same boxes and roles on the host.
//
// Outputs: the diagonal super-tile's transposed products (its strictly
// upper t-tiles) are block R's own, added to its sums; positions past m
// (the last super-row's and super-column's) are never loaded or stored.
// u: each super-tile's block C (the forward operand) rides a ring of two
// slots, and each super-row's block R (the transposed one) two slots of
// its own, copied once a row (copying it again each super-tile made the
// int8 kernel at K = 16 1.7x slower on an H100, PERF.md). The u blocks of a
// partial last super-block copy only positions < m; the slots start as
// zeros, and what a slot keeps past m meets masked data.

// t's stripe rows: the largest of 64, 32, 16 dividing t
__host__ __device__ constexpr int super_stripe(int t) {
  return t % 64 == 0 ? 64 : t % 32 == 0 ? 32 : 16;
}

__device__ __forceinline__ int row_offset(int r, int nt) {
  return r * nt - r * (r - 1) / 2;  // off_r, in tiles
}

struct FlatSuper {
  // panel p (64 rows) of super-tile (R, C) of half h of problem q into
  // stage: stripe a, box bx at (rows a kG, byte column 128 bx)
  template <typename S, int kG>
  __device__ __forceinline__ static void issue(uint8_t* stage,
                                               const CUtensorMap* map, int q,
                                               int h, int R, int C, int p,
                                               int m, int t, int nt, int n,
                                               int view_rows, uint64_t* bar,
                                               int lane) {
    constexpr int kBoxes = (int)sizeof(S);  // 128 elements of 128-byte boxes
    if (lane < kPanel / kG * kBoxes) {
      const int a = lane / kBoxes, bx = lane % kBoxes;
      const int i0 = 128 * R + kPanel * p + a * kG;
      const int r = i0 / t;
      int x = 0, y = view_rows;
      if (i0 < m && 128 * C + 128 > r * t) {
        x = row_offset(r, nt) * t + 128 * C - r * t +
            bx * (128 / (int)sizeof(S));
        y = (q * 2 + h) * t + i0 - r * t;
      }
      tma_load_2d(stage + bx * kPanel * 128 + a * kG * 128, map, x, y, bar);
    }
  }
};

struct TileSuper {
  // stripe a's sub-tile b at (rows a kG, byte column b kG sizeof(S))
  template <typename S, int kG>
  __device__ __forceinline__ static void issue(uint8_t* stage,
                                               const CUtensorMap* map, int q,
                                               int h, int R, int C, int p,
                                               int m, int t, int nt, int n,
                                               int view_rows, uint64_t* bar,
                                               int lane) {
    constexpr int kP = 128 / kG;
    constexpr int kBW = kG * (int)sizeof(S);
    if (lane < kPanel / kG * kP) {  // at most 32 boxes
      const int a = lane / kP, b = lane % kP;
      const int i0 = 128 * R + kPanel * p + a * kG, j0 = 128 * C + b * kG;
      const int r = i0 / t, c = j0 / t;
      int x = 0, y = view_rows;
      if (i0 < m && j0 < m && c >= r) {
        const int k = row_offset(r, nt) + c - r;
        x = j0 - c * t;
        y = ((q * n + k) * 2 + h) * t + i0 - r * t;
      }
      tma_load_2d(stage + b * kPanel * kBW + a * kG * kBW, map, x, y, bar);
    }
  }
};

// One 16-position output block as load_block / store_block, or nothing
// (zeros loaded) at positions past m.
template <bool kCodes, int NK>
__device__ __forceinline__ void load_below(float (&acc)[NK][4],
                                           const float* ob, int K, int m,
                                           int col, int lane) {
  if (col < m)
    load_block<kCodes, NK>(acc, ob, K, m, col, lane);
  else
    zero1(acc);
}

// S, NK as the kernel above; kG: the stripe rows (super_stripe(t)); kBW:
// the stage's column boxes' bytes (128 for FlatSuper, kG sizeof(S) for
// TileSuper); Layout: FlatSuper or TileSuper. Grid (2, B) as above;
// view_rows: the rows of the tensor map's view (a box there is zeros).
template <typename S, int NK, int kG, int kBW, typename Layout>
__global__ void __launch_bounds__(kThreads) tri_super_kernel(
    const __grid_constant__ CUtensorMap tri, const int* __restrict__ idx,
    const __nv_bfloat16* __restrict__ U, float* __restrict__ out, int K,
    int nt, int t, int view_rows, float scale) {
  // T = 128's ring: its two pairs of u slots are u_c 0, 1 and u_r 0, 1
  using L = Ring<S, 128, NK>;
  constexpr int NP = 128 / kPanel;  // panels a super-tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* uslot = smem + L::kCount * L::kBytes;  // u_c 0, 1; u_r 0, 1
  uint64_t* full = reinterpret_cast<uint64_t*>(uslot + L::kUSlots);
  uint64_t* empty = full + L::kCount;
  uint64_t* ufull = empty + L::kCount;  // 2: u_c
  uint64_t* uempty = ufull + 2;         // 2
  uint64_t* rfull = uempty + 2;         // 2: u_r
  uint64_t* rempty = rfull + 2;         // 2

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m = nt * t;
  const int ns = (m + 127) / 128;              // super-tiles a side
  const int total = ns * (ns + 1) / 2 * NP;    // panels of the walk

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kCount; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&ufull[s], 1);
      mbar_init(&uempty[s], kConsumers);
      mbar_init(&rfull[s], 1);
      mbar_init(&rempty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every u slot starts as zeros: candidate rows K .. 8 NK - 1 and the
  // positions past m of a last, short block, which no copy writes
  for (int i = threadIdx.x; i < L::kUSlots / 16; i += kThreads)
    reinterpret_cast<uint4*>(uslot)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  if (warp == kConsumers) {
    const int prob = idx[b];
    const int n = nt * (nt + 1) / 2;
    const __nv_bfloat16* u = U + (size_t)b * K * m;
    int R = 0, C = 0, p = 0, tile = 0;
    for (int it = 0; it < total; ++it) {
      if (p == 0) {
        if (C == R) {
          // the super-row's block of u into u_r slot R % 2
          const int qr = R & 1, lr = min(128, m - 128 * R);
          if (R >= 2) mbar_wait(&rempty[qr], (R / 2 - 1) & 1);
          if (lane == 0) mbar_expect_tx(&rfull[qr], 2 * K * lr);
          __syncwarp();
          for (int nn = lane; nn < K; nn += 32)
            bulk_copy(uslot + (2 + qr) * L::kUBlock + nn * L::kUPitch,
                      u + (size_t)nn * m + R * 128, 2 * lr, &rfull[qr]);
        }
        // the super-tile's block of u into u_c slot tile % 2
        const int q = tile & 1, lc = min(128, m - 128 * C);
        if (tile >= 2) mbar_wait(&uempty[q], (tile / 2 - 1) & 1);
        if (lane == 0) mbar_expect_tx(&ufull[q], 2 * K * lc);
        __syncwarp();
        for (int nn = lane; nn < K; nn += 32)
          bulk_copy(uslot + q * L::kUBlock + nn * L::kUPitch,
                    u + (size_t)nn * m + C * 128, 2 * lc, &ufull[q]);
      }
      const int s = it % L::kCount;
      if (it >= L::kCount) mbar_wait(&empty[s], (it / L::kCount - 1) & 1);
      // the stage was last read by ldmatrix (the generic proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (lane == 0) mbar_expect_tx(&full[s], kPanel * L::kRowBytes);
      __syncwarp();
      Layout::template issue<S, kG>(smem + s * L::kBytes, &tri, prob, h, R,
                                    C, p, m, t, nt, n, view_rows, &full[s],
                                    lane);
      __syncwarp();
      if (++p == NP) {
        p = 0;
        ++tile;
        if (++C == ns) C = ++R;
      }
    }
    return;
  }

  float* ob = out + (size_t)b * K * 2 * m + (size_t)h * m;
  float fwd[NK][4], tr[NK][4], base[NK][4];
  int it = 0, tile = 0;
  // the warp's 16 forward rows and 16 transposed columns: positions
  // 16 warp .. of the super-block
  const int own = 16 * warp;
  for (int R = 0; R < ns; ++R) {
    const int i = 128 * R + own;  // the forward rows' first, of row block
    const int r = i / t;          // r (past m: not stored)
    const int qr = R & 1;
    const uint32_t ur = smem_u32(uslot + (2 + qr) * L::kUBlock);
    if (R == 0)
      zero1(base);
    else
      load_below<L::kCodes, NK>(base, ob, K, m, i, lane);
    zero1(fwd);
    mbar_wait(&rfull[qr], (R / 2) & 1);
    for (int C = R; C < ns; ++C, ++tile) {
      const int q = tile & 1;
      const uint32_t uc = smem_u32(uslot + q * L::kUBlock);
      const int j = 128 * C + own;  // the transposed columns' first
      // forward columns kept: [max(r t, 128 C), m) of the super-tile
      const int flo = max(r * t - 128 * C, 0);
      const int fhi = min(m - 128 * C, 128);
      // transposed rows kept: [128 R, c t), c = j / t, or [128 R, (c + 1)
      // t) off the diagonal super-tile
      const int thi = j < m ? (j / t + (C > R)) * t - 128 * R : 0;
      if (R == 0 || C == R)
        zero1(tr);
      else
        load_below<L::kCodes, NK>(tr, ob, K, m, j, lane);
      mbar_wait(&ufull[q], (tile / 2) & 1);
#pragma unroll
      for (int p = 0; p < NP; ++p, ++it) {
        const int s = it % L::kCount;
        mbar_wait(&full[s], (it / L::kCount) & 1);
        const uint32_t stage = smem_u32(smem + s * L::kBytes);
        if ((warp >> 2) == p && i < m && flo < fhi) {
          float part[NK][4];
          zero1(part);
          if constexpr (L::kCodes)
            forward_i8<128, NK, kPanel, false, kBW, true>(
                part, stage, 16 * (warp & 3), uc, lane, flo, fhi);
          else
            forward_bf16<128, NK, kPanel, false, kBW, true>(
                part, stage, 16 * (warp & 3), uc, lane, flo, fhi);
          add(fwd, part);
        }
        // this panel's rows kept: [0, thi - 64 p)
        const int keep = thi - kPanel * p;
        if (keep > 0) {
          float part[NK][4];
          zero1(part);
          if constexpr (L::kCodes)
            transposed_i8<128, NK, kPanel, false, kBW, true>(
                part, stage, own, ur + 2 * p * kPanel, lane, keep, kPanel);
          else
            transposed_bf16<128, NK, kPanel, false, kBW, true>(
                part, stage, own, ur + 2 * p * kPanel, lane, keep, kPanel);
          add(tr, part);
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&empty[s]);
          if (p == NP - 1) mbar_arrive(&uempty[q]);
        }
      }
      if (C == R)
        add(base, tr);  // the diagonal super-tile's: block R's own
      else if (j < m)
        store_block<L::kCodes, NK>(ob, tr, K, m, j, lane, 1.f);
    }
    // every read of the super-row's u_r slot has returned
    __syncwarp();
    if (lane == 0) mbar_arrive(&rempty[qr]);
    // block R is complete: (its transposed sums + forward) * scale
    if (i < m) {
      add(base, fwd);
      store_block<L::kCodes, NK>(ob, base, K, m, i, lane, scale);
    }
  }
}

// The route by tile of kernels 1 and 9's int8 / bf16 kinds: "mma" where
// the first kernel above is instantiated (t = 128, 256, 384, 512),
// "super" at every other multiple of 16 (tri_super_kernel), else "core"
// (tri_matvec_core.cuh). Their entries report the route they took
// (kRouteMma, kRouteCore or kRouteSuper), which the wrappers count
// launches by; ops/flattri.matvec_route mirrors it for the host's shape
// checks.
bool mma_tile(int t) { return t == 128 || t == 256 || t == 384 || t == 512; }
bool super_tile(int t) { return t % 16 == 0 && !mma_tile(t); }
constexpr int kRouteMma = 0;
constexpr int kRouteCore = 1;
constexpr int kRouteSuper = 2;

// map: the storage's 2-D view as Layout reads it (hopper::storage_map,
// kPanel-row boxes)
template <typename S, int T, int NK, typename Layout>
int launch_mma(const CUtensorMap& map, const void* idx, const void* U,
               void* out, int B, int K, int nt, float scale,
               cudaStream_t stream) {
  using L = Ring<S, T, NK>;
  const cudaError_t err = cudaFuncSetAttribute(
      tri_matvec_mma_kernel<S, T, NK, Layout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  tri_matvec_mma_kernel<S, T, NK, Layout><<<dim3(2, B), kThreads, L::kSmem,
                                            stream>>>(
      map, (const int*)idx, (const __nv_bfloat16*)U, (float*)out, K, nt,
      scale);
  return (int)cudaGetLastError();
}

template <typename S, int NK, int kG, int kBW, typename Layout>
int launch_super_nk(const CUtensorMap& map, const void* idx, const void* U,
                    void* out, int B, int K, int nt, int t, int view_rows,
                    float scale, cudaStream_t stream) {
  using L = Ring<S, 128, NK>;
  const cudaError_t err = cudaFuncSetAttribute(
      tri_super_kernel<S, NK, kG, kBW, Layout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  tri_super_kernel<S, NK, kG, kBW, Layout>
      <<<dim3(2, B), kThreads, L::kSmem, stream>>>(
          map, (const int*)idx, (const __nv_bfloat16*)U, (float*)out, K, nt,
          t, view_rows, scale);
  return (int)cudaGetLastError();
}

// Route "super" over storage of S viewed as `view_rows` rows of `cols`
// elements (kernel 1: (P 2t, S), FlatSuper; kernel 9: (P n 2t, t),
// TileSuper), t a multiple of 16, K <= 16 (NK by K). The tensor map's box
// is (kG rows, 128 bytes) for FlatSuper, (kG rows, kG elements) for
// TileSuper.
template <typename S, bool kTiles, int kG>
int launch_super_g(const void* tri, long long view_rows, long long cols,
                   const void* idx, const void* U, void* out, int B, int K,
                   int nt, int t, float scale, cudaStream_t st) {
  constexpr int kBW = kTiles ? kG * (int)sizeof(S) : 128;
  using Layout = typename std::conditional<kTiles, TileSuper, FlatSuper>::type;
  CUtensorMap map;
  const cudaError_t err = storage_map<S>(&map, tri, view_rows, cols, kG, kBW);
  if (err != cudaSuccess) return (int)err;
  return K <= 8 ? launch_super_nk<S, 1, kG, kBW, Layout>(
                      map, idx, U, out, B, K, nt, t, (int)view_rows, scale,
                      st)
                : launch_super_nk<S, 2, kG, kBW, Layout>(
                      map, idx, U, out, B, K, nt, t, (int)view_rows, scale,
                      st);
}

template <typename S, bool kTiles>
int launch_super(const void* tri, long long view_rows, long long cols,
                 const void* idx, const void* U, void* out, int B, int K,
                 int nt, int t, float scale, cudaStream_t st) {
  // the boxes' row coordinates, the view's past-the-end row included, are
  // 32-bit
  if (t % 16 || K < 1 || K > 16 || view_rows + 64 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  switch (super_stripe(t)) {
    case 64:
      return launch_super_g<S, kTiles, 64>(tri, view_rows, cols, idx, U, out,
                                           B, K, nt, t, scale, st);
    case 32:
      return launch_super_g<S, kTiles, 32>(tri, view_rows, cols, idx, U, out,
                                           B, K, nt, t, scale, st);
    default:
      return launch_super_g<S, kTiles, 16>(tri, view_rows, cols, idx, U, out,
                                           B, K, nt, t, scale, st);
  }
}

}  // namespace
