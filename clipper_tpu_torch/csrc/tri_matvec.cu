// Batched dual matvec over flat upper-triangle pool storage, for Hopper.
//
// Replaces the TPU kernel clipper_tpu/ops/flattri.py:make_tri_pool_matvec
// (Pallas body :184-195, math _seg_matvec_lane :93-149).
//
// What it computes. Storage is (P, 2t, S) with S = t * nt (nt + 1) / 2:
// row-block r's upper tiles (r, r..nt-1) sit side by side at column
// off_r * t, off_r = r nt - r (r - 1) / 2; rows 0:t hold M's tile, rows t:2t
// C's. Lane b reads problem idx[b] and its K candidate rows U[b] (K, m),
// and writes out[b] = [M U^T; C U^T]^T as (K, 2m): for every output
// row-block j, the forward products of tiles (j, c >= j) and the transposed
// products of the strictly-upper tiles (r < j, j). Numerics as the JAX
// kernel's: int8 codes 0..127 become bf16 exactly, storage and u are bf16,
// products accumulate in f32, and the 1/127 scale is applied at the end.
//
// What bounds it on this card. Each tick reads every lane's whole triangle
// once (B * 2t * S bytes for int8: 168 MB at B=128, m=1024) against 2 K
// flops per stored element and direction: ~45 flops/byte at K=16, far below
// the ~295 flops/byte where the bf16 tensor cores would bind. It is bound by
// bytes, so the design reads every stored byte from HBM once.
//
// Design: one read of each tile. M u and C u are independent, so one
// block per (half h, lane b) owns that half's whole output row (K, m) and
// reads only its half's rows of the lane's tiles: tile (r, c)'s t rows of
// half h leave HBM once, in panels of 64 rows. No block needs another's
// data, so there is no cluster, and nt (1 to 16 in the pool) is bounded
// only by the output row. A producer warp copies each panel into a ring of
// shared-memory stages with 2-D tensor-map copies (cp.async.bulk.tensor
// over the (P 2t, S) view of the storage, the row taken from idx[b]; the
// TMA engine), one (64 rows, 128 bytes) box a copy, that complete on the
// stage's "full" mbarrier (one bulk copy a row, 256 bytes at int8, left
// the copies alone well under the memory rate). Eight consumer warps wait
// on it, take BOTH products from the staged copy, and release the stage on
// its "empty" mbarrier, which the producer waits on before refilling it.
// Fragments come from the stage by ldmatrix (forward: the tile's rows are
// outputs) and ldmatrix.trans (transposed: its columns are outputs). The
// candidates' blocks of each tile (u_c for the forward product, u_r for
// the transposed one) are bulk-copied into one of two u slots with
// barriers of their own, so both mma operands come from shared memory
// (read through L1 instead, each u fragment load touches 8 rows of u, and
// at K=16 those loads, not bytes, held the kernel back). The storage tile
// is the m16 operand of mma.sync.m16n8k16 and the K candidates the n8
// operand, so one n8 serves K <= 8 (the K=1 init calls waste 7 of 8
// columns, not 15 of 16 rows). int8 codes become bf16 by the bias trick
// (bf16_mma.cuh); bf16 storage is used as it is.
//
// The panel products (forward and transposed, int8 and bf16 fragments)
// are bf16_mma.cuh's, shared with the capacity engines' kernels; the
// copies, barriers and the tensor map are hopper_copy.cuh's. The copies
// swizzle each 128-byte row segment's 16-byte chunks by the row, so the 8
// rows of an ldmatrix hit distinct banks, except the forward's even rows
// at int8, which meet in pairs (a 2-way conflict).
//
// Determinism. A block walks its tiles in storage order (r = 0..nt-1,
// c = r..nt-1) and owns its outputs outright: no atomics. Forward products
// of row r accumulate in registers; block c's raw sums live in the output
// buffer between tiles: before tile (r, c) the thread that owns them loads
// them (0 at r = 0; loaded ahead, so the latency hides behind the tile),
// adds the tile's transposed panel products in order and stores them back,
// all in program order. When row r ends, block r's outputs are final:
// (transposed sums r' = 0..r-1 + forward sum) * scale. Every output is
// summed in one fixed order, so a rerun reproduces every lane bit for bit.
// The output buffer's read-backs stay in L2 (B * K * 2m * 4 bytes: 17 MB at
// B=128, K=16, m=1024); HBM sees each stored byte once.
//
// The float / double storage kinds take a plain CUDA-core kernel that
// accumulates in the storage type (f64 in f64, as the JAX package does).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ int tile_offset(int r, int nt) {
  return r * nt - r * (r - 1) / 2;
}

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

// S: storage element (int8 codes or bf16); T: tile; NK: n8 column groups
// of candidates (K <= 8 NK). Grid (2, B): blockIdx.x the half (0: M,
// 1: C), blockIdx.y the lane. Warp w < 8 owns the 16-row output blocks
// w + 8 f, f < F, of every t-block of its half's output row.
template <typename S, int T, int NK>
__global__ void __launch_bounds__(kThreads) tri_matvec_mma_kernel(
    const __grid_constant__ CUtensorMap tri, const int* __restrict__ idx,
    const __nv_bfloat16* __restrict__ U, float* __restrict__ out, int K,
    int nt, long long S_cols, float scale) {
  using L = Ring<S, T, NK>;
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
    const int y0 = (idx[b] * 2 + h) * T;  // the half's first storage row
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
        const int x = (tile_offset(r, nt) + c - r) * T;
        for (int bx = 0; bx < L::kBoxes; ++bx)
          tma_load_2d(smem + s * L::kBytes + bx * kPanel * 128, &tri,
                      x + bx * (128 / (int)sizeof(S)), y0 + p * kPanel,
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

template <typename S, int T, int NK>
int launch_mma(const CUtensorMap& map, const void* idx, const void* U,
               void* out, int B, int K, int nt, long long S_cols, float scale,
               cudaStream_t stream) {
  using L = Ring<S, T, NK>;
  const cudaError_t err = cudaFuncSetAttribute(
      tri_matvec_mma_kernel<S, T, NK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  tri_matvec_mma_kernel<S, T, NK><<<dim3(2, B), kThreads, L::kSmem,
                                    stream>>>(
      map, (const int*)idx, (const __nv_bfloat16*)U, (float*)out, K, nt,
      S_cols, scale);
  return (int)cudaGetLastError();
}

template <typename S>
int dispatch_mma(const void* tri, const void* idx, const void* U, void* out,
                 int P, int B, int K, int nt, int t, long long S_cols,
                 float scale, void* stream) {
  if (K < 1 || K > 16 || B < 1 || B > 65535 || nt < 1 || P < 1 ||
      (t != 128 && t != 256))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t err =
      storage_map<S>(&map, tri, (long long)P * 2 * t, S_cols, kPanel);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (t == 256)
    return K <= 8 ? launch_mma<S, 256, 1>(map, idx, U, out, B, K, nt, S_cols,
                                          scale, st)
                  : launch_mma<S, 256, 2>(map, idx, U, out, B, K, nt, S_cols,
                                          scale, st);
  return K <= 8 ? launch_mma<S, 128, 1>(map, idx, U, out, B, K, nt, S_cols,
                                        scale, st)
                : launch_mma<S, 128, 2>(map, idx, U, out, B, K, nt, S_cols,
                                        scale, st);
}

// float / double storage: one thread per output column, K <= 16 sums in
// registers, the same fixed tile order.
template <typename F>
__global__ void __launch_bounds__(256) tri_matvec_float_kernel(
    const F* __restrict__ tri, const int* __restrict__ idx,
    const F* __restrict__ U, F* __restrict__ out, int K, int nt, int t,
    long long S) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int m = nt * t;
  const F* st = tri + (size_t)idx[b] * (size_t)(2 * t) * (size_t)S;
  const F* u = U + (size_t)b * K * m;
  const int off_j = tile_offset(j, nt);
  for (int o = threadIdx.x; o < 2 * t; o += blockDim.x) {
    const int h = o / t;
    const int l = o % t;
    F acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = F(0);
    for (int c = j; c < nt; ++c) {
      const F* row = st + (size_t)o * S + (size_t)(off_j + c - j) * t;
      for (int q = 0; q < t; ++q) {
        const F s = row[q];
        if (s == F(0)) continue;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < K) acc[k] += s * u[(size_t)k * m + c * t + q];
      }
    }
    for (int r = 0; r < j; ++r) {
      const F* colp = st + (size_t)(h * t) * S +
                      (size_t)(tile_offset(r, nt) + j - r) * t + l;
      for (int i = 0; i < t; ++i) {
        const F s = colp[(size_t)i * S];
        if (s == F(0)) continue;
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (k < K) acc[k] += s * u[(size_t)k * m + r * t + i];
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < K)
        out[((size_t)b * K + k) * 2 * m + (size_t)h * m + (size_t)j * t + l] =
            acc[k];
  }
}

}  // namespace

extern "C" {

// tri (P, 2t, S) int8 codes in 0..127, idx (B,) int32, U (B, K, m) bf16,
// out (B, K, 2m) f32; t in (128, 256), K <= 16; tri 16-byte aligned.
int tri_matvec_int8(const void* tri, const void* idx, const void* U, void* out,
                    int P, int B, int K, int nt, int t, long long S,
                    float scale, void* stream) {
  return dispatch_mma<int8_t>(tri, idx, U, out, P, B, K, nt, t, S, scale,
                              stream);
}

// tri (P, 2t, S) bf16, the rest as tri_matvec_int8 (no scale).
int tri_matvec_bf16(const void* tri, const void* idx, const void* U, void* out,
                    int P, int B, int K, int nt, int t, long long S,
                    void* stream) {
  return dispatch_mma<__nv_bfloat16>(tri, idx, U, out, P, B, K, nt, t, S,
                                     1.f, stream);
}

int tri_matvec_f32(const void* tri, const void* idx, const void* U, void* out,
                   int B, int K, int nt, int t, long long S, void* stream) {
  if (K < 1 || K > 16) return (int)cudaErrorInvalidValue;
  tri_matvec_float_kernel<float><<<dim3(nt, B), 256, 0, (cudaStream_t)stream>>>(
      (const float*)tri, (const int*)idx, (const float*)U, (float*)out, K, nt,
      t, S);
  return (int)cudaGetLastError();
}

int tri_matvec_f64(const void* tri, const void* idx, const void* U, void* out,
                   int B, int K, int nt, int t, long long S, void* stream) {
  if (K < 1 || K > 16) return (int)cudaErrorInvalidValue;
  tri_matvec_float_kernel<double>
      <<<dim3(nt, B), 256, 0, (cudaStream_t)stream>>>(
          (const double*)tri, (const int*)idx, (const double*)U,
          (double*)out, K, nt, t, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
