// Hopper's copy machinery, shared by the matvecs that stream stored tiles
// through shared memory (tri_matvec.cu, sym_tile_mma.cuh): shared-memory
// barriers (mbarrier), bulk and 2-D tensor-map copies (the TMA engine),
// ldmatrix fragment loads, the 128-byte swizzle's addressing and the
// host-side tensor-map encoding.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the phase of the given parity to complete; a wait of over
// ~10 s (a protocol fault) traps rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > 20000000000LL) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing as transaction bytes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// one box of the tensor map at element column x, row y, completing as
// transaction bytes on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&q)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&q)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&q)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(q[0]), "=r"(q[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0,%1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// A staged region as the tensor-map copies with the 128-byte swizzle leave
// it: 128-byte column boxes one after the other, each kRows rows of 128
// bytes, the 16-byte chunks of row r XORed with r % 8, so 8 consecutive
// rows at one column hit distinct banks. The region starts on a 1024-byte
// boundary (the swizzle repeats every 8 rows). Returns the offset of row
// r's 16 bytes at byte column x (a multiple of 16).
//
// kBW < 128: column boxes kBW bytes wide (64, 32 or 16), as copies with
// the swizzle of that width leave them (swizzle_of): the swizzle XORs the
// 16-byte chunk index with bits 7 on of the row's offset (r kBW), so the
// rows of 8 consecutive 16-byte chunks at one column still hit distinct
// banks; at 16 bytes there is no swizzle (8 rows are 128 bytes).
template <int kRows, int kBW = 128>
__device__ __forceinline__ uint32_t swizzled_at(int r, int x) {
  if constexpr (kBW == 128) {
    return (uint32_t)((x >> 7) * (kRows * 128) + r * 128 +
                      ((((x >> 4) & 7) ^ (r & 7)) << 4));
  } else {
    constexpr int kMask = kBW / 16 - 1;
    return (uint32_t)((x / kBW) * (kRows * kBW) + r * kBW +
                      ((((x >> 4) & kMask) ^ ((r * kBW >> 7) & kMask))
                       << 4));
  }
}

// the tensor-map swizzle whose pattern swizzled_at<kRows, box_bytes>
// reads: a box row of 128, 64 or 32 bytes, or 16 bytes unswizzled
inline CUtensorMapSwizzle swizzle_of(int box_bytes) {
  return box_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : box_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                           : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// (no link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// A row-major storage of `rows` rows and `cols` columns of S (int8 codes or
// bf16) as a 2-D tensor map, read in (box_rows rows, box_bytes) boxes with
// the swizzle of that width (swizzle_of; 128 bytes by default). Row
// strides must be multiples of 16 bytes. A box wholly or partly outside
// the storage is filled with zeros (and its bytes still complete).
template <typename S>
cudaError_t storage_map(CUtensorMap* map, const void* base, long long rows,
                        long long cols, int box_rows, int box_bytes = 128) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(S)};
  const cuuint32_t box[2] = {(cuuint32_t)(box_bytes / sizeof(S)),
                             (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map,
      sizeof(S) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, steps,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(box_bytes),
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
