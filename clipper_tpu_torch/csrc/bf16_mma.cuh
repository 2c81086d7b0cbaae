// The bf16 tensor-core step and the int8 -> bf16 code conversion shared by
// the triangle matvecs (tri_matvec.cu, sym_tile_mma.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16mma {

// Two int8 codes in 0..127 (the quantizer's range: M in 0..127, C 0 or
// 127), in bytes 0 and 2 of w, as bf16x2 (byte 0 in the low half). The
// bf16 bits 0x4300 | x are 128 + x exactly (ulp 1 in [128, 256)), and the
// bf16 subtraction of 128 is exact: one OR and one HSUB2 at full rate,
// where the int -> float -> bf16 conversions run at a quarter rate.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t w) {
  const uint32_t biased = w | 0x43004300u;
  const uint32_t bias = 0x43004300u;
  __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&biased);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&bias);
  a = __hsub2(a, b);
  return *reinterpret_cast<uint32_t*>(&a);
}

// bytes sel_lo and sel_hi (0..3) of w as a bf16x2 of codes: the selector
// of __byte_perm is 0x4_sel_hi_4_sel_lo (4 picks a zero byte)
template <int kSel>
__device__ __forceinline__ uint32_t codes_of(uint32_t w) {
  return codes_bf16x2(__byte_perm(w, 0u, kSel));
}

// c += a b: mma.sync.m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace bf16mma
