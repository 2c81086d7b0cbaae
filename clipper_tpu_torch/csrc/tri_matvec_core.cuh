// The CUDA-core route of kernels 1 and 9 (tri_matvec.cu, flat storage, K
// candidates a lane; tri_tiles_matvec.cu, tile-major storage, one probe a
// lane): int8 / bf16 at the tiles no tensor-core route takes (route
// "core": t not a multiple of 16, where tri_matvec_mma.cuh's 16-row
// fragments and boxes do not tile the (2t, t) tile), and the f32 / f64
// storage kinds (kernel 1's at every t, kernel 9's but at t = 128 and 256,
// where its warp-row kernel stays). It takes every t <= kMaxT dividing m,
// for every storage kind: int8 codes and bf16 (u rounded to bf16, products
// exact in f32, the 1/127 scale at the end, as the JAX kernel), f32 (f32
// products) and f64 (f64 products).
//
// What bounds it on this card. At K = 16 each stored element costs 2 K
// multiply-adds a direction on the CUDA cores: at W = 16, m = 2000, B =
// 128, t = 100 that is 1.6e10 f32 multiply-adds, 0.55 ms at 29.6 T a
// second (67 TFLOP/s), against 0.03 ms for the bytes. It is bound by
// operations, so the design keeps the threads on multiply-adds: operands
// from shared memory in vector loads that meet in no bank, each loaded
// value used by 4 to 32 multiply-adds, no per-element branch, and each
// stored element read from device memory once for both of its products.
//
// Design: one block per (half h, lane b, group of kKG candidates) walks the
// lane's tiles in storage order (row block r, then c = r..nt-1), so each
// stored byte of its half leaves device memory once a call (a lane's
// candidate groups are launched side by side, so a second group's read of
// a tile comes from L2). A tile's half is walked in blocks of 64 rows by
// kBC columns (128 for int8 / bf16, 64 for f32, 32 for f64), column
// blocks outer, a block a step:
// - Each block is staged through shared memory by coalesced cp.async
//   copies (16 bytes for f32 / f64 rows of whole 16-byte units, else 4,
//   else single bytes), double-buffered: the next block is copied while
//   this one is used. Rows are padded so that 16 threads reading 4
//   elements of 16 consecutive rows meet in no bank.
// - u is staged as [position][candidate] rows in the products' type,
//   zeros past t: block r's once a row (the transposed operand), block c's
//   a tile (the forward operand), the next tile's loaded into registers
//   during a tile's last step and stored after it.
// - Both products come from the staged block, 128 threads each, in
//   register micro-tiles of kC candidates (8; 4 in f64): a transposed
//   thread sums 4 columns over a share of the block's rows (one vector
//   load of 4 stored values and kC / 4 of u a row, 4 kC multiply-adds), a
//   forward thread 4 rows (16 apart) over a share of its columns (4 loads
//   of 4 stored values and 4 kC / 4 of u a column quad, 16 kC
//   multiply-adds). The shares are the block's, split evenly, so an edge
//   block costs its size.
// - Sums. The threads' partial sums go to shared memory; after a barrier
//   they are added in a fixed order: in the products' type over a run of
//   at most kRun rows or columns, the runs in f64, into the row block's
//   forward sums (f64, shared memory, across the row's tiles) and the
//   column block's transposed sums (f64, across the tile's row blocks).
//   At the row's last tile the forward sums are complete: added to block
//   r's raw transposed sums, scaled and written. At a strictly upper
//   tile's last row block the transposed sums go into block c's raw sums
//   in the output buffer, which only this block writes (rounded to the
//   output's type there; block c's raw sums take at most c such adds).
//   The raw sums a step reads are loaded before its products. No atomics,
//   one fixed order: a rerun is bit-identical.
// - Occupancy: two blocks an SM (at most 128 registers a thread, 113 KB
//   of shared memory, candidates halved until they fit), but f64 blocks
//   of 8 or more candidates, which take an SM each (with room for 16
//   candidates at t <= 256: fewer groups reading each tile). Past t =
//   2048 (4096 for f64) a block takes one candidate and, where its shared
//   memory asks, an SM; kMaxT = 7680 is where an f64 block's fills it.
// Numerics: products in runs of up to 64 from zero, each run in the
// products' type (f32 for codes, bf16 and f32 storage; f64 for f64), the
// runs added in f64. Kernels 1 and 9 run the same instructions in the
// same order, so at K = 1 they give the same bits. Measured on an H100
// (bench/tri_matvec_probe --routes, PERF.md): at t=100, int8, K=16 the
// products take about half the time, the barrier-separated copies and
// fixed-order sums the rest.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace core {

constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;  // threads a direction
constexpr int kMaxK = 16;            // candidates a block takes at most
constexpr int kRows = 64;            // a step's block: rows of a half-tile
constexpr int kRun = 64;             // products summed from zero in A
constexpr int kMaxT = 7680;  // an f64 block at kKG = 1 fills an SM
constexpr int kOut = kMaxK * kRows / kThreads;   // a step's sums a thread adds
constexpr int kSmemTwo = 113 * 1024;             // two blocks on an SM
constexpr int kSmemBudget = 227 * 1024;

// t kKG, a u block's values, the prefetch's registers hold: 4096 for f64,
// whose blocks of 8 or more candidates take an SM each (their registers;
// at K = 16 one block an SM measured faster in f64 than two of half the
// candidates), else 2048
__host__ __device__ constexpr int max_items(int abytes) {
  return abytes == 8 ? 4096 : 2048;
}
__host__ __device__ constexpr bool one_block(int abytes, int kg) {
  return abytes == 8 && kg >= 8;
}

// the storage kinds: u's type U, the products' type A, the output's O
template <typename S>
struct Kind {
  using U = __nv_bfloat16;
  using A = float;
  using O = float;
};
template <>
struct Kind<float> {
  using U = float;
  using A = float;
  using O = float;
};
template <>
struct Kind<double> {
  using U = double;
  using A = double;
  using O = double;
};

__device__ __forceinline__ float value(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float value(float x) { return x; }
__device__ __forceinline__ double value(double x) { return x; }

// Where half h of tile k (in storage order) of problem q starts, and its
// row pitch, in elements.
//   Flat (kernel 1): (P, 2t, S) storage, tile k at column k t, pitch S;
//   TileMajor (kernel 9): (P, n, 2t, t) storage, n = nt (nt + 1) / 2,
//     tile k the contiguous (2t, t) block, pitch t.
struct Flat {
  long long S;
  int t;
  __device__ __forceinline__ size_t at(int q, int k, int h, int n) const {
    return ((size_t)q * 2 + h) * (size_t)t * (size_t)S + (size_t)k * t;
  }
  __device__ __forceinline__ size_t pitch() const { return (size_t)S; }
};

struct TileMajor {
  int t;
  __device__ __forceinline__ size_t at(int q, int k, int h, int n) const {
    return (((size_t)q * n + k) * 2 + h) * (size_t)t * (size_t)t;
  }
  __device__ __forceinline__ size_t pitch() const { return (size_t)t; }
};

__host__ __device__ constexpr size_t up16(size_t x) {
  return (x + 15) / 16 * 16;
}

// a step's block's columns: 128 for int8 and bf16, 64 for f32, 32 for f64
// (two blocks' stages and sums fit an SM)
__host__ __device__ constexpr int block_cols(int elem) {
  return elem == 8 ? 32 : elem == 4 ? 64 : 128;
}
// a staged row's bytes: the block's columns and 16 bytes (int8: 4, bf16:
// 8), so that 16 threads reading 4 elements of 16 consecutive rows meet in
// no bank
__host__ __device__ constexpr int block_pitch(int elem) {
  return block_cols(elem) * elem + (elem >= 4 ? 16 : 4 * elem);
}

// The shared memory of one call, the same on the host and in the kernel:
// kg candidates a block, elem the storage's bytes an element, abytes the
// products' type's. u blocks are [position][candidate] rows over tp
// positions, t rounded up to whole 64-row blocks (zeros past t).
struct Shape {
  int t, tp, kg, bc, pitch;
  size_t stage, ur, uc, fwd, cs, pt, pf, smem;

  __host__ __device__ Shape(int t_, int elem, int abytes, int kg_)
      : t(t_), kg(kg_) {
    bc = block_cols(elem);
    const int w = bc > kRows ? bc : kRows;
    tp = (t + w - 1) / w * w;
    pitch = block_pitch(elem);
    stage = 0;                                               // [2][kRows]
    ur = up16(stage + (size_t)2 * kRows * pitch);            // [tp][kg]
    uc = up16(ur + (size_t)tp * kg * abytes);                // [tp][kg]
    fwd = up16(uc + (size_t)tp * kg * abytes);               // [kg][t]
    cs = up16(fwd + (size_t)kg * t * 8);                     // [kg][bc]
    // the splits' partial sums: kHalf threads' 4 x kC values each
    const int kc = abytes == 8 ? (kg < 4 ? kg : 4) : (kg < 8 ? kg : 8);
    pt = up16(cs + (size_t)kg * bc * 8);      // [splits][kg][bc]
    pf = up16(pt + (size_t)kHalf * 4 * kc * abytes);  // [splits][kg][kRows]
    smem = up16(pf + (size_t)kHalf * 4 * kc * abytes);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 4 consecutive staged values (a 4-element-aligned address) in the
// products' type. int8 codes: a byte under 0x4B is the float 2^23 + x +
// 128 exactly (x + 128 in 0..255), one subtraction away from x: two full-
// rate instructions a value, where the conversion unit takes a quarter.
__device__ __forceinline__ void load4(float (&a)[4], const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  a[0] = __uint_as_float(__byte_perm(w, 0x4Bu, 0x4550)) - 8388736.f;
  a[1] = __uint_as_float(__byte_perm(w, 0x4Bu, 0x4551)) - 8388736.f;
  a[2] = __uint_as_float(__byte_perm(w, 0x4Bu, 0x4552)) - 8388736.f;
  a[3] = __uint_as_float(__byte_perm(w, 0x4Bu, 0x4553)) - 8388736.f;
}
__device__ __forceinline__ void load4(float (&a)[4],
                                      const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  a[0] = __uint_as_float(w.x << 16);
  a[1] = __uint_as_float(w.x & 0xFFFF0000u);
  a[2] = __uint_as_float(w.y << 16);
  a[3] = __uint_as_float(w.y & 0xFFFF0000u);
}
__device__ __forceinline__ void load4(float (&a)[4], const float* p) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  a[0] = w.x;
  a[1] = w.y;
  a[2] = w.z;
  a[3] = w.w;
}
__device__ __forceinline__ void load4(double (&a)[4], const double* p) {
  const double2 w0 = reinterpret_cast<const double2*>(p)[0];
  const double2 w1 = reinterpret_cast<const double2*>(p)[1];
  a[0] = w0.x;
  a[1] = w0.y;
  a[2] = w1.x;
  a[3] = w1.y;
}

// kC candidates' u values of one position (vector loads where aligned)
template <int kC, typename A>
__device__ __forceinline__ void load_u(A (&v)[kC], const A* u) {
  if constexpr (std::is_same<A, float>::value && kC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kC; k += 4) {
      const float4 w = *reinterpret_cast<const float4*>(u + k);
      v[k] = w.x;
      v[k + 1] = w.y;
      v[k + 2] = w.z;
      v[k + 3] = w.w;
    }
  } else if constexpr (std::is_same<A, double>::value && kC % 2 == 0) {
#pragma unroll
    for (int k = 0; k < kC; k += 2) {
      const double2 w = *reinterpret_cast<const double2*>(u + k);
      v[k] = w.x;
      v[k + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kC; ++k) v[k] = u[k];
  }
}

// Block (half h, lane b, candidates k0 .. k0 + kKG - 1) of one call; the
// grid is (2 x the candidate groups, lanes). S: the storage; Addr: Flat or
// TileMajor. out (B, K, 2m) of Kind<S>::O.
template <typename S, int kKG, typename Addr>
__global__ void __launch_bounds__(
    kThreads, one_block(sizeof(typename Kind<S>::A), kKG) ? 1 : 2)
    tri_core_kernel(
    const S* __restrict__ tri, const int* __restrict__ idx,
    const typename Kind<S>::U* __restrict__ U,
    typename Kind<S>::O* __restrict__ out, int K, int nt, const Addr addr,
    float scale) {
  using UT = typename Kind<S>::U;
  using A = typename Kind<S>::A;
  using O = typename Kind<S>::O;
  constexpr int kBC = block_cols((int)sizeof(S));
  constexpr int kPitch = block_pitch((int)sizeof(S));
  constexpr int kCMax = sizeof(A) == 8 ? 4 : 8;
  constexpr int kC = kKG < kCMax ? kKG : kCMax;  // candidates a thread
  constexpr int kNcg = kKG / kC;                 // ... groups of them
  constexpr int kQC = kBC / 4;                   // column quads a block
  constexpr int kOutT = kMaxK * kBC / kThreads;  // a step's column sums
  constexpr int kPre = max_items((int)sizeof(A)) / kThreads;  // u values
  // each direction's kHalf threads: transposed (quad, group, row split),
  // forward (row quad, group, column split)
  constexpr int kNR = kHalf / (kQC * kNcg);      // transposed row splits
  constexpr int kNC = kHalf / (16 * kNcg);       // forward column splits
  // the forward's splits summed in A a run (at most kRun columns)
  constexpr int kSR = kRun / (kBC / kNC) < kNC ? kRun / (kBC / kNC) : kNC;
  static_assert(kNR >= 1 && kRows % kNR == 0 && kNC >= 1 &&
                    kBC % (4 * kNC) == 0 && kNC % kSR == 0,
                "the micro-tiles do not divide a block");
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = addr.t;
  const Shape sh(t, (int)sizeof(S), (int)sizeof(A), kKG);
  uint8_t* stg = smem + sh.stage;
  A* ur = reinterpret_cast<A*>(smem + sh.ur);              // [tp][kKG]
  A* uc = reinterpret_cast<A*>(smem + sh.uc);              // [tp][kKG]
  double* fwd = reinterpret_cast<double*>(smem + sh.fwd);  // [kKG][t]
  double* cs = reinterpret_cast<double*>(smem + sh.cs);    // [kKG][kBC]
  A* pt = reinterpret_cast<A*>(smem + sh.pt);  // [kNR][kKG][kBC]
  A* pf = reinterpret_cast<A*>(smem + sh.pf);  // [kNC][kKG][kRows]
  static_assert(kNR * kKG * kBC == kHalf * 4 * kC &&
                    kNC * kKG * kRows == kHalf * 4 * kC,
                "the partial sums' buffers");

  const int tid = threadIdx.x;
  const int h = blockIdx.x & 1;
  const int b = blockIdx.y;
  const int k0 = (blockIdx.x >> 1) * kKG;
  const int Kb = min(kKG, K - k0);
  const int m = nt * t;
  const int n = nt * (nt + 1) / 2;
  const int q = idx[b];
  const size_t ld = addr.pitch();
  const UT* u = U + ((size_t)b * K + k0) * m;
  O* ob = out + ((size_t)b * K + k0) * 2 * m + (size_t)h * m;
  const int nbr = (t + kRows - 1) / kRows;  // row blocks of a half-tile
  const int nbc = (t + kBC - 1) / kBC;      // column blocks
  const int spt = nbr * nbc;                // steps a tile
  // the copies' width: rows of whole units, every row start aligned (the
  // stage's rows are 16-byte aligned for f32 / f64 only)
  const uintptr_t base = reinterpret_cast<uintptr_t>(tri);
  const int row_bytes = t * (int)sizeof(S);
  const int unit = kPitch % 16 == 0 && row_bytes % 16 == 0 && base % 16 == 0
                       ? 16
                       : row_bytes % 4 == 0 && base % 4 == 0 ? 4 : 1;

  // value j of a u block, read 8 positions of a candidate at a time:
  // position p and candidate k
  auto u_slot = [&](int j, int& p, int& k) {
    k = (j >> 3) % kKG;
    p = j / (8 * kKG) * 8 + (j & 7);
  };
  // value j of u block blk (candidates >= Kb and positions >= t as zeros)
  auto u_value = [&](int j, int blk) -> A {
    int p, k;
    u_slot(j, p, k);
    return k < Kb && p < t
               ? (A)value(u[(size_t)k * m + (size_t)blk * t + p])
               : (A)0;
  };
  // step st's block (tile st / spt; column block outer, row block inner)
  // into buffer bf
  auto copy_block = [&](int st, int bf) {
    const int k = st / spt, w = st - k * spt;
    const int j = w / nbr, i = w - j * nbr;
    const int p0 = i * kRows, x0 = j * kBC;
    const int hr = min(kRows, t - p0);
    const int per = min(kBC, t - x0) * (int)sizeof(S) / unit;  // a row's
    const uint8_t* src = reinterpret_cast<const uint8_t*>(
        tri + addr.at(q, k, h, n) + p0 * ld + x0);
    const size_t ldb = ld * sizeof(S);
    uint8_t* dst = stg + bf * kRows * kPitch;
    for (int e = tid; e < hr * per; e += kThreads) {
      const int p = e / per, o = (e - p * per) * unit;
      if (unit == 16)
        cp_async16(dst + p * kPitch + o, src + p * ldb + o);
      else if (unit == 4)
        cp_async4(dst + p * kPitch + o, src + p * ldb + o);
      else
        dst[p * kPitch + o] = src[p * ldb + o];
    }
    cp_async_commit();
  };

  // the stages (stale values past a block's edge stay finite), u blocks 0
  // (zeros past t) and the sums start as zeros
  for (int j = tid; j < (int)((sh.fwd - sh.stage) / 16); j += kThreads)
    reinterpret_cast<uint4*>(smem + sh.stage)[j] = make_uint4(0, 0, 0, 0);
  for (int j = tid; j < kKG * t; j += kThreads) fwd[j] = 0.0;
  for (int j = tid; j < kKG * kBC; j += kThreads) cs[j] = 0.0;
  __syncthreads();
  const int tu = (t + 7) / 8 * 8 * kKG;  // values j < tu cover t positions
  for (int j = tid; j < tu; j += kThreads) {
    int p, k;
    u_slot(j, p, k);
    if (p < t) ur[p * kKG + k] = uc[p * kKG + k] = u_value(j, 0);
  }
  copy_block(0, 0);

  int r = 0, c = 0;
  const int n_steps = n * spt;
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait_all();
    __syncthreads();  // the block, the tile's u and the sums are in
    if (st + 1 < n_steps) copy_block(st + 1, (st + 1) & 1);
    const int w = st % spt, j = w / nbr, i = w - j * nbr;
    const int p0 = i * kRows, x0 = j * kBC;
    const int hr = min(kRows, t - p0), wc = min(kBC, t - x0);
    // a split's rows (transposed) and columns (forward): the block's, in
    // equal shares (whole quads of columns)
    const int rps = (hr + kNR - 1) / kNR;
    const int cps = ((wc + kNC - 1) / kNC + 3) / 4 * 4;
    const bool tile_end = w == spt - 1;
    // block r's rows p0.. complete (the row's last tile, last column
    // block); block c's columns x0.. complete (a strictly upper tile's
    // last row block)
    const bool fin = c == nt - 1 && j == nbc - 1;
    const bool col_end = c > r && i == nbr - 1;
    const bool next = tile_end && st + 1 < n_steps;
    const int nc = c + 1 < nt ? c + 1 : r + 1;  // the next tile's block
    A pre[kPre];  // the next tile's u block, stored after the products
    if (next) {
#pragma unroll
      for (int v = 0; v < kPre; ++v) {
        const int e = tid + v * kThreads;
        pre[v] = e < tu ? u_value(e, nc) : (A)0;
      }
    }
    // the raw sums this step adds to, loaded before the products
    O rawr[kOut], rawc[kOutT];
    if (fin && r > 0) {
#pragma unroll
      for (int v = 0; v < kOut; ++v) {
        const int e = tid + v * kThreads;
        const int k = e / kRows, p = e - k * kRows;
        rawr[v] = k < Kb && p < hr
                      ? ob[(size_t)k * 2 * m + (size_t)r * t + p0 + p]
                      : (O)0;
      }
    }
    if (col_end && r > 0) {
#pragma unroll
      for (int v = 0; v < kOutT; ++v) {
        const int e = tid + v * kThreads;
        const int k = e / kBC, x = e - k * kBC;
        rawc[v] = k < Kb && x < wc
                      ? ob[(size_t)k * 2 * m + (size_t)c * t + x0 + x]
                      : (O)0;
      }
    }
    const uint8_t* blk = stg + (st & 1) * kRows * kPitch;
    if (tid < kHalf) {
      // transposed (a strictly upper tile): columns 4 xq .. 4 xq + 3 over
      // rows rps rs .. of the block, for candidates cg kC ..
      const int xq = tid % kQC, rest = tid / kQC;
      const int cg = rest % kNcg, rs = rest / kNcg;
      if (c > r && rs < kNR) {
        A acc[4][kC];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int k = 0; k < kC; ++k) acc[e][k] = (A)0;
        const int pb = rs * rps, pe = min(hr, pb + rps);
        const uint8_t* row = blk + pb * kPitch + xq * 4 * (int)sizeof(S);
        const A* uu = ur + (size_t)(p0 + pb) * kKG + cg * kC;
#pragma unroll 4
        for (int p = pb; p < pe; ++p, row += kPitch, uu += kKG) {
          A a[4], v[kC];
          load4(a, reinterpret_cast<const S*>(row));
          load_u<kC, A>(v, uu);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int k = 0; k < kC; ++k) acc[e][k] = fma(a[e], v[k], acc[e][k]);
        }
        A* o = pt + ((size_t)rs * kKG + cg * kC) * kBC + xq * 4;
#pragma unroll
        for (int k = 0; k < kC; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[k * kBC + e] = acc[e][k];
      }
    } else {
      // forward: rows pq + 16 i over columns cps cb .. of the block, for
      // candidates cg kC .. (u is zero past t, so a quad's columns past
      // the edge add nothing)
      const int f = tid - kHalf;
      const int pq = f % 16, rest = f / 16;
      const int cg = rest % kNcg, cb = rest / kNcg;
      if (cb < kNC) {
        A acc[4][kC];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int k = 0; k < kC; ++k) acc[e][k] = (A)0;
        const int xb = cb * cps, xe = min(wc, xb + cps);
        for (int x = xb; x < xe; x += 4) {
          A a[4][4];
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4)
            load4(a[i4], reinterpret_cast<const S*>(
                             blk + (pq + 16 * i4) * kPitch +
                             x * (int)sizeof(S)));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            A v[kC];
            load_u<kC, A>(v, uc + (size_t)(x0 + x + e) * kKG + cg * kC);
#pragma unroll
            for (int i4 = 0; i4 < 4; ++i4)
#pragma unroll
              for (int k = 0; k < kC; ++k)
                acc[i4][k] = fma(a[i4][e], v[k], acc[i4][k]);
          }
        }
        A* o = pf + ((size_t)cb * kKG + cg * kC) * kRows + pq;
#pragma unroll
        for (int k = 0; k < kC; ++k)
#pragma unroll
          for (int i4 = 0; i4 < 4; ++i4) o[k * kRows + 16 * i4] = acc[i4][k];
      }
    }
    __syncthreads();  // the partial sums are in
    // the block's rows' forward sums: the column splits' sums added in
    // order, in A within a run of kRun columns, the runs in f64; at fin
    // they are complete: + block r's raw transposed sums, scaled, written
#pragma unroll
    for (int v = 0; v < kOut; ++v) {
      const int e = tid + v * kThreads;
      const int k = e / kRows, p = e - k * kRows;
      if (k >= kKG || p >= hr) continue;
      double s = 0.0;
#pragma unroll
      for (int g = 0; g < kNC; g += kSR) {
        A run = (A)0;
#pragma unroll
        for (int cb = g; cb < g + kSR; ++cb)
          run += pf[((size_t)cb * kKG + k) * kRows + p];
        s += (double)run;
      }
      double* f = fwd + (size_t)k * t + p0 + p;
      if (!fin) {
        *f += s;
      } else {
        if (k < Kb) {
          const double tot = r > 0 ? (double)rawr[v] + (*f + s) : *f + s;
          ob[(size_t)k * 2 * m + (size_t)r * t + p0 + p] = (O)tot * (O)scale;
        }
        *f = 0.0;
      }
    }
    if (c > r) {
      // the block's columns' transposed sums: the row splits' sums added
      // in order in A (one run of the block's rows), then in f64; at
      // col_end into block c's raw sums
#pragma unroll
      for (int v = 0; v < kOutT; ++v) {
        const int e = tid + v * kThreads;
        const int k = e / kBC, x = e - k * kBC;
        if (k >= kKG || x >= wc) continue;
        A run = (A)0;
#pragma unroll
        for (int rs = 0; rs < kNR; ++rs)
          run += pt[((size_t)rs * kKG + k) * kBC + x];
        const double s = (double)run;
        double* cp = cs + (size_t)k * kBC + x;
        if (!col_end) {
          *cp += s;
        } else {
          if (k < Kb)
            ob[(size_t)k * 2 * m + (size_t)c * t + x0 + x] =
                r > 0 ? (O)((double)rawc[v] + (*cp + s)) : (O)(*cp + s);
          *cp = 0.0;
        }
      }
    }
    if (next) {
      // every read of this tile's u ended at the barrier above; at a new
      // row, block r + 1 is also the transposed operand
      const bool new_row = c == nt - 1;
#pragma unroll
      for (int v = 0; v < kPre; ++v) {
        const int e = tid + v * kThreads;
        int p, k;
        u_slot(e, p, k);
        if (e < tu && p < t) {
          uc[p * kKG + k] = pre[v];
          if (new_row) ur[p * kKG + k] = pre[v];
        }
      }
      // past the registers' share (t kKG > max_items: kKG = 1, t > 2048
      // for codes, bf16 and f32, 4096 for f64), loaded here
      for (int e = tid + kPre * kThreads; e < tu; e += kThreads) {
        int p, k;
        u_slot(e, p, k);
        if (p < t) {
          const A x = u_value(e, nc);
          uc[p * kKG + k] = x;
          if (new_row) ur[p * kKG + k] = x;
        }
      }
    }
    if (tile_end) {
      if (c == nt - 1) {
        ++r;
        c = r;
      } else {
        ++c;
      }
    }
  }
}

// the candidates a block takes: the power of 2 at or above min(K, 16),
// halved until a u block's values fit the prefetch's registers (t kg <=
// max_items, t rounded up to 8) and the block's shared memory fits its
// share of an SM, down to 1 (then the block takes an SM's shared memory
// and loads the rest of a u block after the products)
template <typename S>
int core_group(int t, int K) {
  constexpr int ab = (int)sizeof(typename Kind<S>::A);
  int kg = 1;
  while (kg < K && kg < kMaxK) kg *= 2;
  while (kg > 1 &&
         ((long long)(t + 7) / 8 * 8 * kg > max_items(ab) ||
          Shape(t, (int)sizeof(S), ab, kg).smem >
              (size_t)(one_block(ab, kg) ? kSmemBudget : kSmemTwo)))
    kg /= 2;
  return kg;
}

template <typename S, int kKG, typename Addr>
int launch_kg(const void* tri, const void* idx, const void* U, void* out,
              int B, int K, int nt, const Addr& addr, float scale,
              cudaStream_t stream) {
  const Shape sh(addr.t, (int)sizeof(S), (int)sizeof(typename Kind<S>::A),
                 kKG);
  const cudaError_t err =
      cudaFuncSetAttribute(tri_core_kernel<S, kKG, Addr>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sh.smem);
  if (err != cudaSuccess) return (int)err;
  // grid (2 halves x the candidate groups, lanes): a lane's blocks are
  // launched together, so a tile that two groups read leaves device memory
  // once
  tri_core_kernel<S, kKG, Addr>
      <<<dim3(2 * ((K + kKG - 1) / kKG), B), kThreads, sh.smem, stream>>>(
          (const S*)tri, (const int*)idx, (const typename Kind<S>::U*)U,
          (typename Kind<S>::O*)out, K, nt, addr, scale);
  return (int)cudaGetLastError();
}

// One launch: B lanes, K <= 16 candidates, t <= kMaxT.
template <typename S, typename Addr>
int launch_core(const void* tri, const void* idx, const void* U, void* out,
                int B, int K, int nt, const Addr& addr, float scale,
                cudaStream_t stream) {
  if (K < 1 || K > kMaxK || B < 1 || B > 65535 || nt < 1 || addr.t < 1 ||
      addr.t > kMaxT)
    return (int)cudaErrorInvalidValue;
  const int kg = core_group<S>(addr.t, K);
  if (Shape(addr.t, (int)sizeof(S), (int)sizeof(typename Kind<S>::A), kg)
          .smem > (size_t)kSmemBudget)
    return (int)cudaErrorInvalidValue;
  switch (kg) {
    case 16:
      return launch_kg<S, 16>(tri, idx, U, out, B, K, nt, addr, scale,
                              stream);
    case 8:
      return launch_kg<S, 8>(tri, idx, U, out, B, K, nt, addr, scale, stream);
    case 4:
      return launch_kg<S, 4>(tri, idx, U, out, B, K, nt, addr, scale, stream);
    case 2:
      return launch_kg<S, 2>(tri, idx, U, out, B, K, nt, addr, scale, stream);
    default:
      return launch_kg<S, 1>(tri, idx, U, out, B, K, nt, addr, scale, stream);
  }
}

}  // namespace core
