// The bf16 tensor-core steps shared by the triangle matvecs
// (tri_matvec.cu, sym_tile_mma.cuh): the int8 -> bf16
// code conversion, mma.sync.m16n8k16, and the two products of a staged
// panel of stored rows (forward: its rows are outputs; transposed: its
// columns are outputs), with fragments from the 128-byte-swizzled stage by
// ldmatrix and ldmatrix.trans.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_copy.cuh"

namespace bf16mma {

using hopper::ldsm_x2;
using hopper::ldsm_x4;
using hopper::ldsm_x4_t;
using hopper::lds64;
using hopper::swizzled_at;

// Two int8 codes in 0..127 (the quantizer's range: M in 0..127, C 0 or
// 127), bytes sel_lo and sel_hi (0..3) of w, as a bf16x2 (sel_lo in the
// low half): one byte permute puts each code under a 0x43 byte, and the
// bf16 bits 0x4300 | x are 128 + x exactly (ulp 1 in [128, 256)), so one
// bf16x2 subtraction of 128 is exact. The selector of __byte_perm is
// 0x4_sel_hi_4_sel_lo (4 picks a byte of 0x43434343). Two instructions at
// full rate, where the int -> float -> bf16 conversions run at a quarter.
template <int kSel>
__device__ __forceinline__ uint32_t codes_of(uint32_t w) {
  const uint32_t biased = __byte_perm(w, 0x43434343u, kSel);
  const uint32_t bias = 0x43004300u;
  __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&bias);
  a = __hsub2(a, b);
  return *reinterpret_cast<uint32_t*>(&a);
}

// c += a b: mma.sync.m16n8k16, bf16 in, f32 accumulate on the tensor core
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a b for one k16 step: the step's product from zero, then a
// rounded add. The tensor cores truncate as they accumulate, so a chain of
// steps drifts low by up to an ulp a step (a chain over a whole row of
// tiles sat 1.3e-5 from an f64 oracle at m=4096, where the bar is 1.1e-5);
// one step from zero errs by at most an ulp of its own 16 terms, and the
// steps' sums round to nearest.
__device__ __forceinline__ void mma_add(float (&acc)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  float d[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += d[q];
}

// one k16 step of a panel product: chained on the tensor core (kChain: a
// tile's 8 steps from zero, its f32 partial summed exactly by the caller)
// or each step from zero and added rounded (mma_add: a chain over a whole
// row of tiles)
template <bool kChain>
__device__ __forceinline__ void step(float (&acc)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  if constexpr (kChain)
    mma_bf16(acc, a, b0, b1);
  else
    mma_add(acc, a, b0, b1);
}

// A staged block of the candidates' u over one tile's T positions: 8 NK
// rows (candidates; rows >= K read as zero) of T bf16 values, rows
// kPitch bytes apart so the 8 rows of an ldmatrix hit distinct banks.
template <int T>
struct UBlock {
  static constexpr int kPitch = 2 * T + 16;
};

// B fragments (natural k order) of one k16 step for the NK n8 groups, from
// a u block at addr (its column k0 already added): b[nk] = {b0, b1}
template <int T, int NK>
__device__ __forceinline__ void load_b(uint32_t (&b)[NK][2], uint32_t addr,
                                       int lane) {
  constexpr int kUPitch = UBlock<T>::kPitch;
  const int j = lane >> 3;
  if constexpr (NK == 2) {
    // matrix j: rows (lane & 7) + 8 (j >> 1), columns 8 (j & 1) ..
    uint32_t q[4];
    ldsm_x4(q, addr + ((lane & 7) + 8 * (j >> 1)) * kUPitch + 16 * (j & 1));
    b[0][0] = q[0];
    b[0][1] = q[1];
    b[1][0] = q[2];
    b[1][1] = q[3];
  } else {
    uint32_t q[2];
    ldsm_x2(q, addr + (lane & 7) * kUPitch + 16 * (j & 1));
    b[0][0] = q[0];
    b[0][1] = q[1];
  }
}

// ---- the two products of a staged panel of kRows stored rows of a T-wide
// tile (swizzled_at<kRows>), one 16-row output block each. The storage is
// the m16 operand and the candidates the n8 operand (K <= 8 NK).
//
// int8 fragments. ldmatrix moves 16-bit elements, so an int8 stage is read
// as pairs of codes. Forward, a lane gets 4 adjacent codes of one row; the
// contraction index k is permuted within each 16 (a dot product does not
// care), and u is read with the same permutation (8 contiguous bytes).
// Transposed, ldmatrix.trans gives a lane 2 rows x 2 adjacent columns; the
// two columns are two output rows of the mma (2g and 2g + 1 in place of g
// and g + 8), and the forward direction takes its rows in the same order,
// so both directions map an output to the same thread: the accumulators'
// rows g and g + 8 are outputs 2g and 2g + 1 at int8, g and g + 8 at bf16.

// The forward product's int8 A fragments of the two k16 steps at byte
// column kb (a multiple of 32) for the 16 output rows from row0: matrices
// rows 2i | 2i + 1 (i = lane & 7) x bytes 0-15 | 16-31 (the even rows meet
// in pairs of banks: a 2-way conflict, the swizzle's), with k permuted
// within each 16: slots 2tig, 2tig+1 <- codes 4tig, 4tig+1; slots 2tig+8,
// 2tig+9 <- codes 4tig+2, 4tig+3 (u is read in the same order).
template <int kRows, int kBW = 128>
__device__ __forceinline__ void forward_a_i8(uint32_t (&a0)[4],
                                             uint32_t (&a1)[4],
                                             uint32_t stage, int row0,
                                             int kb, int lane) {
  const int rr = row0 + 2 * (lane & 7) + ((lane >> 3) & 1);
  uint32_t q[4];
  ldsm_x4(q, stage + swizzled_at<kRows, kBW>(rr, kb + 16 * (lane >> 4)));
  a0[0] = codes_of<0x4140>(q[0]);
  a0[1] = codes_of<0x4140>(q[1]);
  a0[2] = codes_of<0x4342>(q[0]);
  a0[3] = codes_of<0x4342>(q[1]);
  a1[0] = codes_of<0x4140>(q[2]);
  a1[1] = codes_of<0x4140>(q[3]);
  a1[2] = codes_of<0x4342>(q[2]);
  a1[3] = codes_of<0x4342>(q[3]);
}

// the bf16 forward A fragment of the k16 step at column k: matrices rows
// 0-7 | 8-15 x columns k..k+7 | k+8..k+15
template <int kRows, int kBW = 128>
__device__ __forceinline__ void forward_a_bf16(uint32_t (&a)[4],
                                               uint32_t stage, int row0,
                                               int k, int lane) {
  const int rr = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  ldsm_x4(a, stage + swizzled_at<kRows, kBW>(rr, 2 * k + 16 * (lane >> 4)));
}

// Forward: output rows row0..row0+15 of the stage (complete sums over the
// tile's T columns) against the u block at uc: acc[nk] += A u^T for the
// candidates 8 nk .. 8 nk + 7. kMask: only the columns [lo, hi) (multiples
// of 16) are kept, the others' fragments zeroed (warp-uniform).
template <int T, int NK, int kRows, bool kChain = false, int kBW = 128,
          bool kMask = false>
__device__ __forceinline__ void forward_i8(float (&acc)[NK][4],
                                           uint32_t stage, int row0,
                                           uint32_t uc, int lane, int lo = 0,
                                           int hi = T) {
  constexpr int kUPitch = UBlock<T>::kPitch;
  const int g = lane >> 2, tig = lane & 3;
  // u in the permuted k order of forward_a_i8: 4 values a lane, from
  // column 4 tig
  const uint32_t ub = uc + g * kUPitch + 8 * tig;
#pragma unroll
  for (int kb = 0; kb < T; kb += 32) {
    uint32_t a0[4], a1[4];
    forward_a_i8<kRows, kBW>(a0, a1, stage, row0, kb, lane);
    if constexpr (kMask) {
      if (kb < lo || kb >= hi) a0[0] = a0[1] = a0[2] = a0[3] = 0u;
      if (kb + 16 < lo || kb + 16 >= hi) a1[0] = a1[1] = a1[2] = a1[3] = 0u;
    }
#pragma unroll
    for (int nk = 0; nk < NK; ++nk) {
      const uint32_t un = ub + 8 * nk * kUPitch + 2 * kb;
      const uint2 v0 = lds64(un);
      const uint2 v1 = lds64(un + 32);
      step<kChain>(acc[nk], a0, v0.x, v0.y);
      step<kChain>(acc[nk], a1, v1.x, v1.y);
    }
  }
}

template <int T, int NK, int kRows, bool kChain = false, int kBW = 128,
          bool kMask = false>
__device__ __forceinline__ void forward_bf16(float (&acc)[NK][4],
                                             uint32_t stage, int row0,
                                             uint32_t uc, int lane,
                                             int lo = 0, int hi = T) {
#pragma unroll
  for (int k = 0; k < T; k += 16) {
    uint32_t a[4], b[NK][2];
    forward_a_bf16<kRows, kBW>(a, stage, row0, k, lane);
    if constexpr (kMask) {
      if (k < lo || k >= hi) a[0] = a[1] = a[2] = a[3] = 0u;
    }
    load_b<T, NK>(b, uc + 2 * k, lane);
#pragma unroll
    for (int nk = 0; nk < NK; ++nk)
      step<kChain>(acc[nk], a, b[nk][0], b[nk][1]);
  }
}

// Transposed: output columns l0..l0+15 of the stage's tile, partial sums
// over the stage's kRows rows, against the u block from ur (the column of
// the panel's first row). kMask: the rows [lo, hi) (multiples of 16) are
// left out, their fragments zeroed (warp-uniform).
template <int T, int NK, int kRows, bool kChain = false, int kBW = 128,
          bool kMask = false>
__device__ __forceinline__ void transposed_i8(float (&acc)[NK][4],
                                              uint32_t stage, int l0,
                                              uint32_t ur, int lane,
                                              int lo = 0, int hi = 0) {
#pragma unroll
  for (int kb = 0; kb < kRows; kb += 32) {
    // matrix j: rows kb + 8 j .. + 7, bytes l0 .. l0 + 15; a lane gets rows
    // 2tig, 2tig+1 of columns 2g, 2g+1 (bytes: (2tig, 2g), (2tig, 2g+1),
    // (2tig+1, 2g), (2tig+1, 2g+1))
    uint32_t q[4], b0[NK][2], b1[NK][2];
    ldsm_x4_t(q, stage + swizzled_at<kRows, kBW>(kb + lane, l0));
    if constexpr (kMask) {
      if (kb >= lo && kb < hi) q[0] = q[1] = 0u;
      if (kb + 16 >= lo && kb + 16 < hi) q[2] = q[3] = 0u;
    }
    const uint32_t a0[4] = {codes_of<0x4240>(q[0]), codes_of<0x4341>(q[0]),
                            codes_of<0x4240>(q[1]), codes_of<0x4341>(q[1])};
    const uint32_t a1[4] = {codes_of<0x4240>(q[2]), codes_of<0x4341>(q[2]),
                            codes_of<0x4240>(q[3]), codes_of<0x4341>(q[3])};
    load_b<T, NK>(b0, ur + 2 * kb, lane);
    load_b<T, NK>(b1, ur + 2 * (kb + 16), lane);
#pragma unroll
    for (int nk = 0; nk < NK; ++nk) {
      step<kChain>(acc[nk], a0, b0[nk][0], b0[nk][1]);
      step<kChain>(acc[nk], a1, b1[nk][0], b1[nk][1]);
    }
  }
}

template <int T, int NK, int kRows, bool kChain = false, int kBW = 128,
          bool kMask = false>
__device__ __forceinline__ void transposed_bf16(float (&acc)[NK][4],
                                                uint32_t stage, int l0,
                                                uint32_t ur, int lane,
                                                int lo = 0, int hi = 0) {
  const int j = lane >> 3;
#pragma unroll
  for (int kb = 0; kb < kRows; kb += 16) {
    // matrix j: rows kb + 8 (j >> 1) .. + 7, columns l0 + 8 (j & 1) .. + 7
    uint32_t a[4], b[NK][2];
    ldsm_x4_t(a, stage + swizzled_at<kRows, kBW>(
                        kb + (lane & 7) + 8 * (j >> 1),
                        2 * (l0 + 8 * (j & 1))));
    if constexpr (kMask) {
      if (kb >= lo && kb < hi) a[0] = a[1] = a[2] = a[3] = 0u;
    }
    load_b<T, NK>(b, ur + 2 * kb, lane);
#pragma unroll
    for (int nk = 0; nk < NK; ++nk)
      step<kChain>(acc[nk], a, b[nk][0], b[nk][1]);
  }
}

// The forward product's B fragments of a whole u block, for every k16 step
// of a T-wide tile (int8: in the permuted k order of forward_i8), so that
// the tiles of one column take them from registers, not shared memory.
template <typename S, int T, int NK>
__device__ __forceinline__ void load_forward_u(uint32_t (&b)[T / 16][NK][2],
                                               uint32_t uc, int lane) {
  constexpr int kUPitch = UBlock<T>::kPitch;
  if constexpr (sizeof(S) == 1) {
    const uint32_t ub = uc + (lane >> 2) * kUPitch + 8 * (lane & 3);
#pragma unroll
    for (int kb = 0; kb < T; kb += 32)
#pragma unroll
      for (int nk = 0; nk < NK; ++nk) {
        const uint32_t un = ub + 8 * nk * kUPitch + 2 * kb;
        const uint2 v0 = lds64(un);
        const uint2 v1 = lds64(un + 32);
        b[kb / 16][nk][0] = v0.x;
        b[kb / 16][nk][1] = v0.y;
        b[kb / 16 + 1][nk][0] = v1.x;
        b[kb / 16 + 1][nk][1] = v1.y;
      }
  } else {
#pragma unroll
    for (int k = 0; k < T; k += 16) load_b<T, NK>(b[k / 16], uc + 2 * k, lane);
  }
}

// forward_i8 / forward_bf16 with the u block's fragments from registers
// (load_forward_u)
template <typename S, int T, int NK, int kRows, bool kChain, int kBW = 128>
__device__ __forceinline__ void forward_regs(float (&acc)[NK][4],
                                             uint32_t stage, int row0,
                                             const uint32_t (&b)[T / 16][NK][2],
                                             int lane) {
  if constexpr (sizeof(S) == 1) {
#pragma unroll
    for (int kb = 0; kb < T; kb += 32) {
      uint32_t a0[4], a1[4];
      forward_a_i8<kRows, kBW>(a0, a1, stage, row0, kb, lane);
#pragma unroll
      for (int nk = 0; nk < NK; ++nk) {
        step<kChain>(acc[nk], a0, b[kb / 16][nk][0], b[kb / 16][nk][1]);
        step<kChain>(acc[nk], a1, b[kb / 16 + 1][nk][0],
                     b[kb / 16 + 1][nk][1]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < T; k += 16) {
      uint32_t a[4];
      forward_a_bf16<kRows, kBW>(a, stage, row0, k, lane);
#pragma unroll
      for (int nk = 0; nk < NK; ++nk)
        step<kChain>(acc[nk], a, b[k / 16][nk][0], b[k / 16][nk][1]);
    }
  }
}

// the transposed product of storage type S (int8 codes or bf16); kMask:
// rows [lo, hi) left out (transposed_i8)
template <typename S, int T, int NK, int kRows, bool kChain = false,
          int kBW = 128, bool kMask = false>
__device__ __forceinline__ void transposed(float (&acc)[NK][4],
                                           uint32_t stage, int l0,
                                           uint32_t ur, int lane, int lo = 0,
                                           int hi = 0) {
  if constexpr (sizeof(S) == 1)
    transposed_i8<T, NK, kRows, kChain, kBW, kMask>(acc, stage, l0, ur, lane,
                                                    lo, hi);
  else
    transposed_bf16<T, NK, kRows, kChain, kBW, kMask>(acc, stage, l0, ur,
                                                      lane, lo, hi);
}

}  // namespace bf16mma
