// The dense MSRC solve (graduated projected gradient ascent) of one
// problem as one persistent kernel: the u0 rescale, the outer homotopy,
// the inner ascent and the backtracking line search, with every loop
// condition decided on the device.
//
// Replaces the JAX package's three nested lax.while_loops of
// clipper_tpu/solvers/msrc.py (find_dense_clique: :236, :254, :288),
// which XLA compiled into one device program and for which the JAX
// package wrote no Pallas kernel. The port's host loop
// (solvers/msrc._run_pga) stays the plain version: it reads each loop
// condition back to the host, about 48 reads and several hundred small
// launches a solve at m=2048. This kernel runs _run_pga step for step,
// with every Params field, the dtype floors of the thresholds (passed in,
// computed on the host by msrc._floor), the frozen check, the stall guard
// and the ifinal rule, in the working precision T (float or double).
//
// What bounds it on this card: its matrix-vector products, (m, m) values
// read once each (16.8 MB at m=2048 in f32, 5 us at 3.35 TB/s, less
// where the matrix stays in the 50 MB L2): the rescale's M, M and C for
// each d, one formation of Md = M + d C an outer pass (M and C read, Md
// written) and one Md a line-search trial, about 47 matrix passes a solve
// at the benchmark's m=2048 (0.16-0.23 ms of HBM bytes); plus one
// grid-wide barrier a trial and three an outer pass.
//
// Design. A cooperative launch of the co-resident block count (the
// occupancy query times the SMs, capped by m); block b owns the rows
// [b m / G, (b + 1) m / G) of every matrix and vector. u, the gradient,
// the trial vector and the row products live in a global scratch vector
// (L2-resident, read with ld.global.cg: other blocks write it). A matrix
// pass stages the vector it multiplies in shared memory, 32 KB at a time,
// and a warp takes a row (or a share of one where a block has fewer rows
// than warps); the matrices are read from global memory / L2 at every m.
// A scalar that needs the whole grid (a norm of the rescale, sum(u), the
// objective, |unew - u|^2, the d terms' counts and sums) leaves each
// block as one partial (a fixed shuffle tree in each warp, then the warps
// in order) before cooperative_groups' grid barrier, and after it every
// block sums the G partials in the same fixed order: every block holds
// the same value bit for bit and takes the same branch. A line-search
// trial has one barrier: every block forms the whole clamped step u +
// alpha g itself, sums its squares and, as it stages unew, sum(unew) in
// the same order as every other block; its rows' (Md unew), gradient,
// objective and |unew - u|^2 partials then meet at the barrier. No float
// atomics: the kernel is deterministic. With fuse_md, Md = fl(M + fl(d C))
// is formed once an outer pass into an (m, m) scratch, the torch path's
// values; otherwise the products keep the reference's order, M u + (C u)
// d. Built with --fmad=false, so every elementwise step rounds as the
// plain version's separate operations do; the sums run in another order
// than the host loop's (cuBLAS's, torch's reductions).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 3;  // scalar sums a phase publishes at most
// values of the vector a block stages in shared memory at a time
constexpr int kCapBytes = 32 * 1024;

template <typename T>
struct PgaArgs {
  const T* M;
  const T* C;
  const T* u0;
  T* Md;      // (m, m) scratch, fuse_md only
  T* vec;     // 5 m scratch: u, g, tmp, un (trial), gn (trial)
  T* part;    // 2 banks x kSlots x G partial sums
  T* u_out;   // (m,)
  T* F_out;   // ()
  int* ints;  // ifinal, trials, inner steps, outer passes
  int m;
  int maxoliters, maxiniters, maxlsiters;
  T beta, eps, tol_u, tol_F, floor_eps, floor_act;
  int rescale_u0, fuse_md, stall_outers;  // stall_outers 0: no guard
};

__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }
__device__ __forceinline__ double ld(const double* p) { return __ldcg(p); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// torch.maximum: NaN in either gives NaN
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // the same on every lane: each level adds the same pair
}

// The block's fixed-order sums of K per-thread values (a shuffle tree in
// each warp, then the warps' sums by warp 0's tree), in every thread.
// s_b holds kWarps * kSlots + kSlots values.
template <typename T, int K>
__device__ __forceinline__ void block_sum(const T (&v)[K], T (&out)[K],
                                          T* s_b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T w = warp_sum(v[k]);
    if (lane == 0) s_b[warp * kSlots + k] = w;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T t = warp_sum(lane < kWarps ? s_b[lane * kSlots + k] : T(0));
      if (lane == 0) s_b[kWarps * kSlots + k] = t;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) out[k] = s_b[kWarps * kSlots + k];
  __syncthreads();  // s_b free again
}

// The grid's fixed-order sums of K per-thread values: each block's sum
// (block_sum's order) goes to global memory, one bank of partials a phase
// in turn, so a phase never writes the bank the previous one is still
// reading; after the grid barrier every block sums the G partials in the
// same order.
template <typename T>
struct Reducer {
  T* part;
  int G;
  int bank;
  T* s_b;

  template <int K>
  __device__ void sum(cg::grid_group& grid, const T (&v)[K], T (&out)[K]) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    T* p = part + (size_t)bank * kSlots * G;
    T blk[K];
    block_sum<T, K>(v, blk, s_b);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) p[(size_t)k * G + blockIdx.x] = blk[k];
    }
    grid.sync();
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        T t = 0;
#pragma unroll 4
        for (int q = lane; q < G; q += 32) t += ld(p + (size_t)k * G + q);
        t = warp_sum(t);
        if (lane == 0) s_b[kWarps * kSlots + k] = t;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = s_b[kWarps * kSlots + k];
    __syncthreads();  // s_b free again
    bank ^= 1;
  }
};

// Row products of the block's rows [r0, r0 + R) with a vector x whose
// value j is xval(j): x is staged in shared memory (s_x, kCap values) a
// chunk at a time, and step(offset of row's column c0, j - c0, x_j, acc)
// adds column j's terms into the NA accumulators; finish(row, acc) takes
// each row's sums. Rows go kWarps at a time: a warp takes a row, or a
// 1/K share of each chunk's columns where fewer rows than warps are left
// (K = kWarps / rows), the shares then summed in order. The first group's
// staging adds each x_j into the calling thread's xsum. Every thread of
// the block calls it.
template <typename T, int NA, class XVal, class Step, class Finish>
__device__ __forceinline__ void rows_pass(int r0, int R, int m, T* s_x,
                                          T* s_part, T& xsum, XVal xval,
                                          Step step, Finish finish) {
  constexpr int kCap = kCapBytes / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g0 = 0; g0 < R; g0 += kWarps) {
    const int Rg = min(kWarps, R - g0);
    const int K = kWarps / Rg;
    const int items = Rg * K;  // one a warp, at most kWarps
    const bool busy = warp < items;
    const int r = warp / K, k = warp - r * K;
    const size_t row = (size_t)(r0 + g0 + (busy ? r : 0)) * (size_t)m;
    T acc[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = 0;
    for (int c0 = 0; c0 < m; c0 += kCap) {
      const int cw = min(kCap, m - c0);
      __syncthreads();  // the previous chunk is read
      for (int j = threadIdx.x; j < cw; j += kThreads) {
        const T x = xval(c0 + j);
        s_x[j] = x;
        if (g0 == 0) xsum += x;
      }
      __syncthreads();
      if (busy) {
        const int j0 = (int)((long long)k * cw / K);
        const int j1 = (int)((long long)(k + 1) * cw / K);
#pragma unroll 8
        for (int j = j0 + lane; j < j1; j += 32)
          step(row + c0, j, s_x[j], acc);
      }
    }
    if (busy) {
#pragma unroll
      for (int a = 0; a < NA; ++a) acc[a] = warp_sum(acc[a]);
    }
    if (K == 1) {
      if (busy && lane == 0) finish(r0 + g0 + r, acc);
    } else {
      if (busy && lane == 0) {
#pragma unroll
        for (int a = 0; a < NA; ++a) s_part[warp * NA + a] = acc[a];
      }
      __syncthreads();
      if (threadIdx.x < Rg) {
        const int rr = threadIdx.x;
        T sum[NA];
#pragma unroll
        for (int a = 0; a < NA; ++a) sum[a] = s_part[rr * K * NA + a];
        for (int kk = 1; kk < K; ++kk) {
#pragma unroll
          for (int a = 0; a < NA; ++a) sum[a] += s_part[(rr * K + kk) * NA + a];
        }
        finish(r0 + g0 + rr, sum);
      }
    }
  }
  __syncthreads();  // the rows' results written, s_x and s_part free
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pga_dense_kernel(const PgaArgs<T> a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T s_x[kCapBytes / sizeof(T)];
  __shared__ T s_part[kWarps * 2];
  __shared__ T s_b[kWarps * kSlots + kSlots];
  const int m = a.m, G = gridDim.x;
  const int r0 = (int)((long long)blockIdx.x * m / G);
  const int r1 = (int)((long long)(blockIdx.x + 1) * m / G);
  const int R = r1 - r0;
  const T* __restrict__ M = a.M;
  const T* __restrict__ C = a.C;
  const T* __restrict__ u0 = a.u0;
  T* u = a.vec;
  T* g = a.vec + m;
  T* const tmp = a.vec + 2 * (size_t)m;
  T* un = a.vec + 3 * (size_t)m;
  T* gn = a.vec + 4 * (size_t)m;
  Reducer<T> red{a.part, G, 0, s_b};
  const T zero = 0, one = 1;
  T unused = zero;

  // ---- the u0 rescale: u = (M u0 + u0) / |M u0 + u0| (or u0 / |u0|) ----
  if (a.rescale_u0) {
    rows_pass<T, 1>(
        r0, R, m, s_x, s_part, unused, [&](int j) { return __ldg(u0 + j); },
        [&](size_t row, int j, T x, T(&acc)[1]) {
          acc[0] += __ldg(M + row + j) * x;
        },
        [&](int i, const T(&acc)[1]) { tmp[i] = acc[0] + __ldg(u0 + i); });
  } else {
    for (int i = r0 + threadIdx.x; i < r1; i += kThreads) tmp[i] = u0[i];
    __syncthreads();
  }
  T su;
  {
    T ss[1] = {zero}, out[1];
    for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
      const T x = ld(tmp + i);
      ss[0] += x * x;
    }
    red.sum(grid, ss, out);
    const T nrm = root(out[0]);
    T s[1] = {zero};
    for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
      const T x = ld(tmp + i) / nrm;
      u[i] = x;
      s[0] += x;
    }
    red.sum(grid, s, out);
    su = out[0];
  }

  // compute_d_terms over u with su = sum(u): idxD = (C-bar u > eps_active)
  // & (u > eps), ratio = (M u + u) / C-bar u; returns |idxD|, the sum of
  // ratio over it and of |ratio|. M u goes to tmp, C u to gn.
  auto d_terms = [&](T (&out)[3]) {
    rows_pass<T, 2>(
        r0, R, m, s_x, s_part, unused, [&](int j) { return ld(u + j); },
        [&](size_t row, int j, T x, T(&acc)[2]) {
          acc[0] += __ldg(M + row + j) * x;
          acc[1] += __ldg(C + row + j) * x;
        },
        [&](int i, const T(&acc)[2]) {
          tmp[i] = acc[0];
          gn[i] = acc[1];
        });
    const T eps_act = tmax(a.eps, a.floor_act * su);
    T s[3] = {zero, zero, zero};
    for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
      const T ui = ld(u + i);
      const T cbu = (su - ld(gn + i)) - ui;
      const bool idx = (cbu > eps_act) && (ui > a.eps);
      const T ratio = (ld(tmp + i) + ui) / (idx ? cbu : one);
      if (idx) {
        s[0] += one;
        s[1] += ratio;
        s[2] += ratio < zero ? -ratio : ratio;
      }
    }
    red.sum(grid, s, out);
  };

  T d;
  {
    T t[3];
    d_terms(t);
    d = t[0] > zero ? t[1] / t[0] : zero;
  }

  int i_out = 0, stall = 0, trials = 0, inner = 0, outer = 0;
  T F = zero;
  while (i_out < a.maxoliters) {
    ++outer;
    const T onepd = one + d;
    // ---- gradient at u: (1 + d) u - d sum(u) + Md u, and F = u'grad ----
    if (a.fuse_md) {
      T* __restrict__ Md = a.Md;
      rows_pass<T, 1>(
          r0, R, m, s_x, s_part, unused, [&](int j) { return ld(u + j); },
          [&](size_t row, int j, T x, T(&acc)[1]) {
            const T md = __ldg(M + row + j) + d * __ldg(C + row + j);
            Md[row + j] = md;
            acc[0] += md * x;
          },
          [&](int i, const T(&acc)[1]) { gn[i] = acc[0]; });
    } else {
      rows_pass<T, 2>(
          r0, R, m, s_x, s_part, unused, [&](int j) { return ld(u + j); },
          [&](size_t row, int j, T x, T(&acc)[2]) {
            acc[0] += __ldg(M + row + j) * x;
            acc[1] += __ldg(C + row + j) * x;
          },
          [&](int i, const T(&acc)[2]) { gn[i] = acc[0] + acc[1] * d; });
    }
    {
      T s[1] = {zero}, out[1];
      const T dsu = d * su;
      for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
        const T ui = ld(u + i);
        const T gi = (onepd * ui - dsu) + ld(gn + i);
        g[i] = gi;
        s[0] += ui * gi;
      }
      red.sum(grid, s, out);
      F = out[0];
    }

    // ---- inner ascent ----
    int j = 0;
    T du_first = zero;
    while (j < a.maxiniters) {
      ++inner;
      T Fnew = F, deltaF = zero, deltau = zero;
      if (a.maxlsiters > 0) {
        // ---- backtracking line search: one grid barrier a trial ----
        const T absF = F < zero ? -F : F;
        const T eps_F = tmax(a.eps, a.floor_eps * absF);
        T alpha = one, su_n = zero, du2 = zero;
        for (int t = 0; t < a.maxlsiters; ++t) {
          ++trials;
          // the trial's norm: every block forms the whole clamped step
          // u + alpha g and sums its squares in the same order
          T nrm;
          {
            T ss[1] = {zero}, out[1];
            for (int i = threadIdx.x; i < m; i += kThreads) {
              T x = ld(u + i) + alpha * ld(g + i);
              x = x < zero ? zero : x;
              ss[0] += x * x;
            }
            block_sum<T, 1>(ss, out, s_b);
            nrm = root(out[0]);
          }
          // the trial unew = clamp(u + alpha g, 0) / nrm, staged; Md unew
          // for the block's rows, and sum(unew) from the staging
          auto unew = [&](int i) {
            T x = ld(u + i) + alpha * ld(g + i);
            x = x < zero ? zero : x;
            return x / nrm;
          };
          {
            T xs = zero;
            if (a.fuse_md) {
              const T* Md = a.Md;
              rows_pass<T, 1>(
                  r0, R, m, s_x, s_part, xs, unew,
                  [&](size_t row, int jj, T x, T(&acc)[1]) {
                    acc[0] += ld(Md + row + jj) * x;
                  },
                  [&](int i, const T(&acc)[1]) { gn[i] = acc[0]; });
            } else {
              rows_pass<T, 2>(
                  r0, R, m, s_x, s_part, xs, unew,
                  [&](size_t row, int jj, T x, T(&acc)[2]) {
                    acc[0] += __ldg(M + row + jj) * x;
                    acc[1] += __ldg(C + row + jj) * x;
                  },
                  [&](int i, const T(&acc)[2]) {
                    gn[i] = acc[0] + acc[1] * d;
                  });
            }
            T s[1] = {xs}, out[1];
            block_sum<T, 1>(s, out, s_b);
            su_n = out[0];
          }
          // the trial's gradient, F and |unew - u|^2 for the block's rows
          {
            T s[2] = {zero, zero}, out[2];
            const T dsu = d * su_n;
            for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
              const T x = unew(i);
              un[i] = x;
              const T gi = (onepd * x - dsu) + ld(gn + i);
              gn[i] = gi;
              s[0] += x * gi;
              const T dx = x - ld(u + i);
              s[1] += dx * dx;
            }
            red.sum(grid, s, out);
            Fnew = out[0];
            du2 = out[1];
          }
          deltaF = Fnew - F;
          if (!(deltaF < -eps_F)) break;
          alpha = alpha * a.beta;
        }
        deltau = root(du2);
        T* swap = u;
        u = un;
        un = swap;
        swap = g;
        g = gn;
        gn = swap;
        su = su_n;
      }
      const T absFn = Fnew < zero ? -Fnew : Fnew;
      const T tol_F = tmax(a.tol_F, a.floor_eps * absFn);
      F = Fnew;
      ++j;
      if (j == 1) du_first = deltau;
      const T absdF = deltaF < zero ? -deltaF : deltaF;
      if ((deltau < a.tol_u) || (absdF < tol_F)) break;
    }
    // frozen: converged on the very first step without moving u (with no
    // step, u did not move: |u - u_in| = 0)
    const bool frozen = j <= 1 && ((j == 0 ? zero : du_first) < a.tol_u);

    T t[3];
    d_terms(t);
    const bool active = t[0] > zero;
    if (active) {
      d = d + t[2] / t[0];
      ++i_out;
    }
    stall = frozen ? stall + 1 : 0;
    if (!active || (a.stall_outers > 0 && stall >= a.stall_outers)) break;
  }

  for (int i = r0 + threadIdx.x; i < r1; i += kThreads) a.u_out[i] = ld(u + i);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *a.F_out = F;
    a.ints[0] = i_out;
    a.ints[1] = trials;
    a.ints[2] = inner;
    a.ints[3] = outer;
  }
}

template <typename T>
int launch(const void* M, const void* C, const void* u0, void* Md, void* vec,
           void* part, void* u_out, void* F_out, void* ints, int m, int grid,
           int maxoliters, int maxiniters, int maxlsiters, double beta,
           double eps, double tol_u, double tol_F, double floor_eps,
           double floor_act, int rescale_u0, int fuse_md, int stall_outers,
           void* stream) {
  if (m < 1 || grid < 1 || grid > m) return (int)cudaErrorInvalidValue;
  PgaArgs<T> a{(const T*)M, (const T*)C, (const T*)u0, (T*)Md, (T*)vec,
               (T*)part, (T*)u_out, (T*)F_out, (int*)ints, m, maxoliters,
               maxiniters, maxlsiters, (T)beta, (T)eps, (T)tol_u, (T)tol_F,
               (T)floor_eps, (T)floor_act, rescale_u0, fuse_md,
               stall_outers};
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)pga_dense_kernel<T>, dim3(grid), dim3(kThreads), params,
      0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The co-resident block count of the kernel in T (f64 != 0: double) on
// `device`: the occupancy query times the SMs; and the scalar slots of a
// bank of partials (the scratch holds 2 banks x slots x grid values).
int pga_dense_grid(int f64, int device, int* grid, int* slots) {
  int per_sm = 0, sms = 0;
  cudaError_t e = f64 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            &per_sm, pga_dense_kernel<double>, kThreads, 0)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                            &per_sm, pga_dense_kernel<float>, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  *grid = per_sm * sms;
  *slots = kSlots;
  return 0;
}

// M, C (m, m) row-major, u0 (m,) in T; Md (m, m) scratch (fuse_md only),
// vec 5 m, part 2 x slots x grid values; out: u (m,), F (), ints (4,):
// ifinal, line-search trials, inner steps, outer passes. grid <= m and
// at most pga_dense_grid's count. The tolerances, eps and the floors are
// the working precision's values (msrc.pga_dense_args).
int pga_dense_f32(const void* M, const void* C, const void* u0, void* Md,
                  void* vec, void* part, void* u_out, void* F_out,
                  void* ints, int m, int grid, int maxoliters,
                  int maxiniters, int maxlsiters, double beta, double eps,
                  double tol_u, double tol_F, double floor_eps,
                  double floor_act, int rescale_u0, int fuse_md,
                  int stall_outers, void* stream) {
  return launch<float>(M, C, u0, Md, vec, part, u_out, F_out, ints, m, grid,
                       maxoliters, maxiniters, maxlsiters, beta, eps, tol_u,
                       tol_F, floor_eps, floor_act, rescale_u0, fuse_md,
                       stall_outers, stream);
}

int pga_dense_f64(const void* M, const void* C, const void* u0, void* Md,
                  void* vec, void* part, void* u_out, void* F_out,
                  void* ints, int m, int grid, int maxoliters,
                  int maxiniters, int maxlsiters, double beta, double eps,
                  double tol_u, double tol_F, double floor_eps,
                  double floor_act, int rescale_u0, int fuse_md,
                  int stall_outers, void* stream) {
  return launch<double>(M, C, u0, Md, vec, part, u_out, F_out, ints, m,
                        grid, maxoliters, maxiniters, maxlsiters, beta, eps,
                        tol_u, tol_F, floor_eps, floor_act, rescale_u0,
                        fuse_md, stall_outers, stream);
}

}  // extern "C"
