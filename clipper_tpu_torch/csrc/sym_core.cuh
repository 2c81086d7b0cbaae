// The capacity matvecs' CUDA-core route (sym_rows_matvec.cu,
// sym_tiles_matvec.cu): int8 / bf16 storage at a tile t that is not a
// multiple of 16 (route "core", ops/symstore.matvec_route), where the
// tensor-core unit kernel's boxes and fragments do not fit the tile.
//
// Replaces, for those tiles, the TPU kernels
// clipper_tpu/ops/symstore.py:make_sym_dual_matvec_pallas_rows (launch
// :754) and make_sym_dual_matvec_pallas (launch :398): the (Mu, Cu) dual
// matvec of stored (2t, t) [M; C] tiles of the symmetric triangle against
// K candidate rows of u, each tile applied forward and, off the diagonal,
// transposed.
//
// What bounds it on an H100. At m = 65,600, t = 100, K = 16 the int8 tiles
// are 4.31 GB, 1.29 ms at 3.35 TB/s; the products are 2 x 4.3e9 x 16 =
// 1.4e11 multiply-adds, 4.1 ms at the 67 TFLOP/s of f32 on the CUDA cores
// (8.1 ms in f64): bound by operations, not bytes. So the products run in
// f32 (an int8 code or a bf16 value times a bf16 u is exact in f32), in
// runs of kRun = 64 terms, each run's f32 sum added in f64 (kernel 1's
// core route adds runs of 16, tri_matvec_core.cuh; here runs of 16 took
// 23.4 ms at t = 100, K = 16 against 18.1 for runs of 64 on an H100 80GB
// HBM3, the f32 -> f64 conversions and shared-memory adds of the runs'
// sums, and both stay within the checks' 1.1e-5 of an f64 oracle); every
// byte of a tile is read from device memory once a call.
//
// Design: the unit plan and reduction of the tensor-core route
// (sym_tile_mma.cuh: units of R row blocks by S column blocks, walked
// column by column, partials in fixed slots, summed in the plan's order by
// a second kernel, no float atomics, so a rerun is bit-identical), over
// the t-grid itself, with the unit sized by rows (R t about 256 at 16
// candidates, S t about 4096; ops/symstore.core_shape). A block takes one
// unit, one half of [M; C] and kKG candidates; two blocks share a
// multiprocessor:
// - Each tile's half is staged through shared memory in panels of rho
//   rows (the whole half where it fits in 24 KB), coalesced 4-byte
//   cp.async copies (bytes where a row is not a multiple of 4 bytes),
//   double-buffered: the next panel is copied while this one is used.
// - u is staged once: the unit's R row blocks at its start, each column's
//   block while the previous column's last panel is in use, as f32
//   [position][candidate] rows (f64 for the float kinds), read as
//   broadcasts.
// - Both products come from the staged panel, each thread taking two
//   positions against one load of u (and at 16 candidates, 8 of them, two
//   threads a position pair): threads from the bottom sum columns over
//   the panel's rows (the transposed product, into the column's f64 sums
//   in shared memory until the column ends), threads from the top sum
//   the panel's rows in nseg segments of columns (the forward product),
//   whose segment sums are added in order into the unit's row sums (f64,
//   shared memory). No per-element branch: zero codes are multiplied too.
// The float kinds (f32 / f64 storage) run the same kernel with f64
// products and sums.

#pragma once

#include <type_traits>

#include "sym_tile_mma.cuh"

namespace symcore {

using symtile::kMetaColEnd;
using symtile::kMetaColWrite;
using symtile::kMetaRow;
using symtile::kMetaSlotShift;
using symtile::kMetaTransposed;
using symtile::Plan;

constexpr int kThreads = 256;
constexpr int kWhole = 24 * 1024;   // a half-tile up to this is one panel
constexpr int kPanel = 16 * 1024;   // else panels of about this
constexpr int kRun = 64;            // f32 terms a run
constexpr int kMaxT = 4096;         // t * kKG <= 4096 at kKG >= 1
constexpr int kSmemBudget = 227 * 1024;

// candidates a block takes at tile t (ops/symstore.core_shape): the
// transposed sums of t columns, kKG candidates each, fit 16 registers a
// thread
__host__ __device__ inline int core_group(int t) {
  return t <= 256 ? 16 : t <= 512 ? 8 : t <= 1024 ? 4 : t <= 2048 ? 2 : 1;
}

// the geometry of one call, the same on the host and in the kernel: kg
// the candidates a block takes (core_group(t), or the power of 2 at or
// above K when K is fewer)
struct Shape {
  int t, kg, R;        // tile, candidates a block, unit rows
  int pitch;           // a staged row's bytes (an odd count of words)
  int rho, npan;       // rows a panel, panels a tile
  int nseg, seg;       // the forward product's column segments
  int us;              // bytes of a staged u value
  size_t fwd, cs, scr, ur, uc, stage, smem;  // shared memory offsets

  __host__ __device__ Shape(int t_, int elem, int R_, bool f64, int kg_)
      : t(t_), kg(kg_), R(R_) {
    const int rb = t * elem;
    const int w = elem == 8 ? 8 : 4;
    int pw = (rb + w - 1) / w;
    if (pw % 2 == 0) ++pw;
    pitch = pw * w;
    rho = (size_t)t * pitch <= (size_t)kWhole ? t : kPanel / pitch;
    if (rho < 1) rho = 1;
    npan = (t + rho - 1) / rho;
    nseg = (t + rho - 1) / rho;
    seg = (t + nseg - 1) / nseg;
    us = f64 ? 8 : 4;
    fwd = 0;
    cs = fwd + (size_t)R * t * kg * 8;
    scr = cs + (size_t)t * kg * 8;
    ur = scr + (size_t)nseg * rho * kg * 8;
    uc = ur + (size_t)R * t * kg * us;
    stage = (uc + (size_t)2 * t * kg * us + 15) / 16 * 16;
    smem = stage + 2 * (((size_t)rho * pitch + 15) / 16 * 16);
  }
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a stored value as the product's type: f32 for codes and bf16 (exact),
// else f64
__host__ __device__ __forceinline__ float value_of(int8_t x) {
  return (float)x;
}
__host__ __device__ __forceinline__ float value_of(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__host__ __device__ __forceinline__ double value_of(float x) {
  return (double)x;
}
__host__ __device__ __forceinline__ double value_of(double x) { return x; }

// row p, column q of a staged panel
template <typename F>
__device__ __forceinline__ auto staged(const uint8_t* panel, int pitch,
                                       int p, int q) {
  return value_of(reinterpret_cast<const F*>(panel + (size_t)p * pitch)[q]);
}

// a[k] += v * u[k] and b[k] += w * u[k] for the kKG staged candidates of
// one position: two stored values against one load of u
template <int kKG, typename A>
__device__ __forceinline__ void axpy2(A (&a)[kKG], A (&b)[kKG], A v, A w,
                                      const A* u) {
  if constexpr (std::is_same<A, float>::value && kKG % 4 == 0) {
#pragma unroll
    for (int k = 0; k < kKG; k += 4) {
      const float4 x = *reinterpret_cast<const float4*>(u + k);
      a[k] = fmaf(v, x.x, a[k]);
      a[k + 1] = fmaf(v, x.y, a[k + 1]);
      a[k + 2] = fmaf(v, x.z, a[k + 2]);
      a[k + 3] = fmaf(v, x.w, a[k + 3]);
      b[k] = fmaf(w, x.x, b[k]);
      b[k + 1] = fmaf(w, x.y, b[k + 1]);
      b[k + 2] = fmaf(w, x.z, b[k + 2]);
      b[k + 3] = fmaf(w, x.w, b[k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kKG; ++k) {
      const A x = u[k];
      a[k] = fma(v, x, a[k]);
      b[k] = fma(w, x, b[k]);
    }
  }
}

// Block (unit, half h, candidates k0 .. k0 + kKG - 1) of one call. F: the
// storage; UT: u's type (bf16 for codes, else F); A: the products' type.
// store: the storage's 2-D view, ld elements a row; a plan entry's tile
// at (x, y) in it (its C half the stored tile's t rows below); fslots R a
// unit. The f64 sums live in shared memory, [candidate][position], so
// that a warp's threads (consecutive positions) meet in no bank and a
// thread keeps no more than two blocks a multiprocessor need.
template <typename F, typename UT, int kKG>
__global__ void __launch_bounds__(kThreads, 2) sym_core_kernel(
    const F* __restrict__ store, long long ld, Plan plan, int R,
    const UT* __restrict__ U, double* __restrict__ ws, int K, int m, int t,
    long long ws_group) {
  using A = decltype(value_of(F()));
  constexpr bool kF64 = std::is_same<A, double>::value;
  constexpr int kPre = 16;  // u values a thread stages (t kKG <= 4096)
  // candidates a thread's products take: 16 split over two threads, so
  // that twice the threads share a tile's products
  constexpr int kC = kKG >= 16 ? 8 : kKG;
  constexpr int kSplit = kKG / kC;
  extern __shared__ __align__(16) uint8_t smem[];
  const Shape sh(t, (int)sizeof(F), R, kF64, kKG);
  double* fwd = reinterpret_cast<double*>(smem + sh.fwd);  // [R][kKG][t]
  double* cs = reinterpret_cast<double*>(smem + sh.cs);    // [kKG][t]
  double* scr = reinterpret_cast<double*>(smem + sh.scr);  // [nseg][kKG][rho]
  A* ur = reinterpret_cast<A*>(smem + sh.ur);              // [R][t][kKG]
  A* uc = reinterpret_cast<A*>(smem + sh.uc);              // [2][t][kKG]
  uint8_t* stg = smem + sh.stage;
  const size_t stage_bytes = ((size_t)sh.rho * sh.pitch + 15) / 16 * 16;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int k0 = blockIdx.z * kKG;
  const int Kb = min(kKG, K - k0);
  const int Kg = min(K, kKG);
  const int4 unit = plan.units[blockIdx.x];
  const int* fs = plan.fslots + (size_t)blockIdx.x * R;
  const int4* ent = plan.entries + unit.x;
  const int n_ent = unit.y - unit.x;
  const UT* u = U + (size_t)k0 * m;
  double* wsb = ws + blockIdx.z * ws_group;
  const int row_bytes = t * (int)sizeof(F);
  const bool words = row_bytes % 4 == 0;
  const int unit_len = words ? 4 : 1;             // bytes a copy
  const int per_row = row_bytes / unit_len;       // copies a row

  // u block `blk` into dst [t][kKG] (candidates >= Kb as zeros)
  auto stage_u = [&](A* dst, int blk) {
    for (int j = tid; j < t * kKG; j += kThreads) {
      const int p = j / kKG, k = j - p * kKG;
      dst[j] = k < Kb ? (A)symtile::f64_of(u[(size_t)k * m +
                                             (size_t)blk * t + p])
                      : (A)0;
    }
  };
  // panel `st` of the walk (tile st / npan, rows (st % npan) rho ..) into
  // buffer b: cp.async words, or bytes where a row is not whole words;
  // thread tid copies items tid, tid + kThreads, .. of the panel's rows
  const int step_rows = kThreads / per_row, step_col = kThreads % per_row;
  const int first_row = tid / per_row, first_col = tid % per_row;
  auto copy_panel = [&](int st, int b) {
    const int4 en = ent[st / sh.npan];
    const int p0 = (st % sh.npan) * sh.rho;
    const int rows = min(sh.rho, t - p0);
    const uint8_t* src = reinterpret_cast<const uint8_t*>(
        store + ((long long)en.y + (long long)h * t + p0) * ld + en.x);
    const size_t ldb = (size_t)ld * sizeof(F);
    uint8_t* dst = stg + b * stage_bytes;
    int p = first_row, w = first_col;
    while (p < rows) {
      if (words)
        cp_async4(dst + (size_t)p * sh.pitch + 4 * w, src + p * ldb + 4 * w);
      else
        dst[(size_t)p * sh.pitch + w] = src[p * ldb + w];
      p += step_rows;
      w += step_col;
      if (w >= per_row) {
        w -= per_row;
        ++p;
      }
    }
    cp_async_commit();
  };

  for (int j = tid; j < R * t * kKG; j += kThreads) fwd[j] = 0.0;
  for (int j = tid; j < t * kKG; j += kThreads) cs[j] = 0.0;
  for (int i = 0; i < R; ++i)
    if (fs[i] >= 0) stage_u(ur + (size_t)i * t * kKG, unit.z + i);
  if (n_ent > 0) {
    stage_u(uc, ent[0].z);
    copy_panel(0, 0);
  }

  int cbuf = 0;
  const int n_steps = n_ent * sh.npan;
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait_all();
    __syncthreads();  // the panel, the column's u and the sums are in
    if (st + 1 < n_steps) copy_panel(st + 1, (st + 1) & 1);
    const int e = st / sh.npan, pn = st % sh.npan;
    const int meta = ent[e].w;
    const int i = meta & kMetaRow;
    const int p0 = pn * sh.rho;
    const int rows = min(sh.rho, t - p0);
    const bool col_end = pn == sh.npan - 1 && (meta & kMetaColEnd);
    const bool next_col = col_end && e + 1 < n_ent;
    // the next column's block of u, loaded now and staged after this
    // panel's products
    A pre[kPre];
    if (next_col) {
      const int blk = ent[e + 1].z;
#pragma unroll
      for (int v = 0; v < kPre; ++v) {
        const int j = tid + v * kThreads;
        const int p = j / kKG, k = j - p * kKG;
        pre[v] = j < t * kKG && k < Kb
                     ? (A)symtile::f64_of(u[(size_t)k * m + (size_t)blk * t +
                                            p])
                     : (A)0;
      }
    }
    const uint8_t* panel = stg + (st & 1) * stage_bytes;
    const A* ucol = uc + (size_t)cbuf * t * kKG;
    const A* urow = ur + (size_t)i * t * kKG + (size_t)p0 * kKG;
    // transposed: columns q and q + tq's sums over the panel's rows for
    // kC of the candidates (kSplit threads a column pair), runs of kRun
    // added into the columns' f64 sums (one load of u a row for both)
    const int tq = (t + 1) / 2;
    if (meta & kMetaTransposed) {
      for (int it = tid; it < tq * kSplit; it += kThreads) {
        const int q = it % tq, c0 = it / tq * kC;
        const int q2 = q + tq < t ? q + tq : q;
        for (int pb = 0; pb < rows; pb += kRun) {
          const int pe = min(rows, pb + kRun);
          A r0[kC], r1[kC];
#pragma unroll
          for (int k = 0; k < kC; ++k) r0[k] = r1[k] = (A)0;
#pragma unroll 4
          for (int p = pb; p < pe; ++p)
            axpy2<kC, A>(r0, r1, staged<F>(panel, sh.pitch, p, q),
                         staged<F>(panel, sh.pitch, p, q2),
                         urow + (size_t)p * kKG + c0);
#pragma unroll
          for (int k = 0; k < kC; ++k) {
            cs[(size_t)(c0 + k) * t + q] += (double)r0[k];
            if (q2 != q) cs[(size_t)(c0 + k) * t + q2] += (double)r1[k];
          }
        }
      }
    }
    // forward: rows p and p + rq's sums over columns [sg seg, (sg + 1)
    // seg) for kC of the candidates, threads from the top, into their
    // segment sums
    const int rq = (rows + 1) / 2;
    for (int f = kThreads - 1 - tid; f < rq * sh.nseg * kSplit;
         f += kThreads) {
      const int c0 = f / (rq * sh.nseg) * kC, g = f % (rq * sh.nseg);
      const int sg = g / rq, p = g - sg * rq;
      const int p2 = p + rq < rows ? p + rq : p;
      const int q0 = sg * sh.seg, q1 = min(t, q0 + sh.seg);
      double* o = scr + ((size_t)sg * kKG + c0) * sh.rho + p;
      double* o2 = o + (p2 - p);
#pragma unroll
      for (int k = 0; k < kC; ++k) o[(size_t)k * sh.rho] = 0.0;
      if (p2 != p) {
#pragma unroll
        for (int k = 0; k < kC; ++k) o2[(size_t)k * sh.rho] = 0.0;
      }
      for (int qb = q0; qb < q1; qb += kRun) {
        const int qe = min(q1, qb + kRun);
        A r0[kC], r1[kC];
#pragma unroll
        for (int k = 0; k < kC; ++k) r0[k] = r1[k] = (A)0;
#pragma unroll 4
        for (int q = qb; q < qe; ++q)
          axpy2<kC, A>(r0, r1, staged<F>(panel, sh.pitch, p, q),
                       staged<F>(panel, sh.pitch, p2, q),
                       ucol + (size_t)q * kKG + c0);
#pragma unroll
        for (int k = 0; k < kC; ++k) {
          o[(size_t)k * sh.rho] += (double)r0[k];
          if (p2 != p) o2[(size_t)k * sh.rho] += (double)r1[k];
        }
      }
    }
    __syncthreads();  // the segment sums are in
    for (int x = tid; x < rows * kKG; x += kThreads) {
      const int k = x / rows, p = x - k * rows;
      double s = 0.0;
      for (int sg = 0; sg < sh.nseg; ++sg)
        s += scr[((size_t)sg * kKG + k) * sh.rho + p];
      fwd[((size_t)i * kKG + k) * t + p0 + p] += s;
    }
    if (col_end) {
      // a thread's own columns' sums (their only writer)
      double* o = wsb + ((size_t)(meta >> kMetaSlotShift) * 2 + h) * Kg * t;
      for (int q = tid; q < t; q += kThreads)
#pragma unroll
        for (int k = 0; k < kKG; ++k) {
          if ((meta & kMetaColWrite) && k < Kb)
            o[(size_t)k * t + q] = cs[(size_t)k * t + q];
          cs[(size_t)k * t + q] = 0.0;
        }
      if (next_col) {
        // the previous column's buffer: its last reader passed the
        // barrier above
        cbuf ^= 1;
        A* dst = uc + (size_t)cbuf * t * kKG;
#pragma unroll
        for (int v = 0; v < kPre; ++v) {
          const int j = tid + v * kThreads;
          if (j < t * kKG) dst[j] = pre[v];
        }
      }
    }
  }
  __syncthreads();
  for (int i = 0; i < R; ++i) {
    if (fs[i] < 0) continue;
    double* o = wsb + ((size_t)fs[i] * 2 + h) * Kg * t;
    for (int x = tid; x < Kb * t; x += kThreads)
      o[x] = fwd[(size_t)i * kKG * t + x];
  }
}

template <typename F, typename UT, int kKG>
cudaError_t launch_core_kernel(const F* store, long long ld, const Plan& plan,
                               int R, const UT* U, double* ws, int K, int m,
                               int t, long long ws_group, size_t smem,
                               cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      sym_core_kernel<F, UT, kKG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.n_units, 2, (K + kKG - 1) / kKG);
  sym_core_kernel<F, UT, kKG><<<grid, kThreads, smem, st>>>(
      store, ld, plan, R, U, ws, K, m, t, ws_group);
  return cudaGetLastError();
}

// Both passes of one call over storage of F viewed with ld elements a row,
// nt stored t-tiles a side, with the plan's arrays over the t-grid
// (ops/symstore.core_plan: fslots R a unit): the CUDA-core kernel, then
// the reduction, on the caller's stream. ws holds groups x n_slots x 2 x
// Kg x t doubles, Kg = min(K, core_group(t)), a group for each
// core_group(t) candidates.
template <typename F, typename UT>
int launch_core(const void* storage, long long ld, const void* entries,
                const void* units, const void* fslots, int n_units, int R,
                const void* red_off, const void* red_slots, int n_slots,
                const void* U, void* out, void* ws, int K, int nt, int t,
                int raw, float scale, void* stream) {
  const Plan plan{(const int4*)entries, (const int4*)units,
                  (const int*)fslots,   n_units,
                  (const int*)red_off,  (const int*)red_slots,
                  n_slots};
  using A = decltype(value_of(F()));
  if (K < 1 || nt < 1 || t < 1 || t > kMaxT || R < 1 || R > 8 ||
      n_units < 0)
    return (int)cudaErrorInvalidValue;
  const int group = core_group(t);  // the workspace's candidate groups
  int kg = 1;                         // the kernel's: K alone if fewer
  while (kg < group && kg < K) kg *= 2;
  const Shape sh(t, (int)sizeof(F), R, std::is_same<A, double>::value, kg);
  if (sh.smem > (size_t)kSmemBudget || (K + group - 1) / group > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int m = nt * t;
  const int Kg = K < group ? K : group;
  const long long ws_group = (long long)n_slots * 2 * Kg * t;
  const F* s = (const F*)storage;
  const UT* u = (const UT*)U;
  double* w = (double*)ws;
  if (n_units > 0) {
    cudaError_t err;
    switch (sh.kg) {
      case 16:
        err = launch_core_kernel<F, UT, 16>(s, ld, plan, R, u, w, K, m, t,
                                            ws_group, sh.smem, st);
        break;
      case 8:
        err = launch_core_kernel<F, UT, 8>(s, ld, plan, R, u, w, K, m, t,
                                           ws_group, sh.smem, st);
        break;
      case 4:
        err = launch_core_kernel<F, UT, 4>(s, ld, plan, R, u, w, K, m, t,
                                           ws_group, sh.smem, st);
        break;
      case 2:
        err = launch_core_kernel<F, UT, 2>(s, ld, plan, R, u, w, K, m, t,
                                           ws_group, sh.smem, st);
        break;
      default:
        err = launch_core_kernel<F, UT, 1>(s, ld, plan, R, u, w, K, m, t,
                                           ws_group, sh.smem, st);
    }
    if (err != cudaSuccess) return (int)err;
  }
  symtile::sym_reduce_kernel<<<dim3(nt, 2, (K + group - 1) / group),
                               symtile::kThreads, 0, st>>>(
      (const double*)ws, plan.red_off, plan.red_slots, out, K, group, t, m,
      ws_group, raw, scale);
  return (int)cudaGetLastError();
}

}  // namespace symcore
