// One stored entry of a [M; C] build: the storage step shared by the
// stacked builds (stored_pair_build.cuh), the triangle builds
// (tri_pair_build.cuh) and the dense build (affinity_build.cu).
//   int8: M = clip(rint(127 s), 0, 127) (round half to even, as
//         jnp.round), C = 127;
//   bf16: M = bf16(s) rounded to nearest even from the f32 score, C = 1;
//   f32, f64: M = s, C = 1, in the score's own type;
// and M = C = 0 where the pair is not kept.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void put(int8_t* M, int8_t* C, bool keep,
                                    float s) {
  int8_t mq = 0, cq = 0;
  if (keep) {
    const float q = rintf(__fmul_rn(s, 127.f));
    mq = (int8_t)fminf(fmaxf(q, 0.f), 127.f);
    cq = 127;
  }
  *M = mq;
  *C = cq;
}

__device__ __forceinline__ void put(__nv_bfloat16* M, __nv_bfloat16* C,
                                    bool keep, float s) {
  *M = __float2bfloat16_rn(keep ? s : 0.f);
  *C = __float2bfloat16_rn(keep ? 1.f : 0.f);
}

template <typename T>
__device__ __forceinline__ void put(T* M, T* C, bool keep, T s) {
  static_assert(sizeof(T) >= 4, "f32 or f64: the score's own type");
  *M = keep ? s : (T)0;
  *C = keep ? (T)1 : (T)0;
}

}  // namespace
