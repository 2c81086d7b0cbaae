// An invariant's own score inside the build kernels 2, 8, 4 and 6: the
// adaptor from the functor an invariant's device score supplies
// (invariants.DeviceScore: its C++ source, its width d and up to four
// parameters) to the score functor the build bodies take
// (tri_pair_build.cuh, stored_pair_build.cuh).
//
// Replaces what the JAX package's Pallas builds did by tracing: they ran
// any symmetric invariant's score_block_t (clipper_tpu/ops/flattri.py:
// 492-498, 593-596; ops/affinity_pallas.py:66-70, 168-179) inside the
// kernel. Here the invariant supplies the score as C++ instead, and
// _kernels compiles one library a device score at first use: a .cu that
// includes this header, the invariant's source and the four builds'
// launch templates (tri_build.cuh, tri_build_fused.cuh,
// stored_pair_build.cuh, affinity_build.cuh), under the build kernels'
// flags (--fmad=false), keyed by the SHA-1 of its text, the headers and
// the flags. Its entries are the built-in entries' with the prefix user_
// (user_tri_build_int8, ...), and they take kind kUserKind only.
//
// The invariant's source defines
//
//   template <typename T> struct Score {
//     static constexpr int D = ...;   // values a set, 1 <= D <= kMaxUserD
//     using Value = T;                // float or double
//     __host__ __device__ Score(const double (&p)[4]);  // its parameters
//     __device__ T operator()(const T* r1, const T* c1,
//                             const T* r2, const T* c2) const;
//   };
//
// with euclid_score.cuh's contract for operator(): r1, c1 the row's and
// the column's D values in set 1, r2, c2 in set 2; the score s >= +0,
// symmetric bit for bit; its steps those of the invariant's plain PyTorch
// version (the builds run under --fmad=false, and euclid_score.cuh's
// helpers rn_*, m_sqrt, m_exp, m_acos, m_abs, m_clamp are at hand) where
// its codes are to equal the plain build's. It may add the pair body's
// stages, each over the same four pointers:
//
//   __device__ bool screen(r1, c1, r2, c2, T& v) const;  // false only
//       where the score is 0 for certain (it runs for every pair)
//   __device__ bool gate(r1, c1, r2, c2, T& v) const;    // false where
//       the score is 0, v what the tail needs
//   __device__ T tail(r1, c1, r2, c2, T v) const;         // the score
//       where the gate passed, operator()'s value bit for bit
//   static constexpr bool kExactScreen;  // the screen is the gate (v is
//       the gate's), where a code is as wide as T (the dense build)
//
// gate and tail go together. Without a screen the adaptor passes every
// pair to the second pass; without gate and tail its gate runs
// operator() and passes, and its tail returns that value, so the codes
// are operator()'s in either case.
//
// Records: the pair body keeps a general record a row, [set 1's D values,
// set 2's D values, the two association ids], padded to 16 bytes
// (tri_pair_build.cuh's Ends with kTailAt = -1: the tail reads the whole
// record as the gate did). kMaxUserD is the widest record kernel 8's
// sub-tile branch holds in a block's shared memory beside its bf16 stages
// (tri_build_fused.cuh: 80-byte records at D = 9).

#pragma once

#include <type_traits>

#include "euclid_score.cuh"

constexpr int kMaxUserD = 9;  // invariants.MAX_USER_D
constexpr int kUserKind = 2;  // invariants.USER_KIND

template <typename T>
struct Score;  // the invariant's, defined by its source

namespace user_detail {

template <typename S, typename = void>
struct has_screen : std::false_type {};
template <typename S>
struct has_screen<S, std::void_t<decltype(&S::screen)>> : std::true_type {};

template <typename S, typename = void>
struct has_split : std::false_type {};
template <typename S>
struct has_split<S, std::void_t<decltype(&S::gate), decltype(&S::tail)>>
    : std::true_type {};

template <typename S, typename = void>
struct exact_screen : std::false_type {};
template <typename S>
struct exact_screen<S, std::void_t<decltype(S::kExactScreen)>>
    : std::bool_constant<S::kExactScreen> {};

}  // namespace user_detail

template <typename T>
struct UserScore {
  using User = Score<T>;
  static constexpr int D = User::D;
  using Value = T;
  static_assert(std::is_same_v<typename User::Value, T>,
                "Score<T>::Value must be T");
  static_assert(D >= 1 && D <= kMaxUserD,
                "a device score takes 1 <= D <= kMaxUserD values a set");
  static constexpr bool kScreen = user_detail::has_screen<User>::value;
  static constexpr bool kSplit = user_detail::has_split<User>::value;
  static constexpr bool kExactScreen =
      kScreen && user_detail::exact_screen<User>::value;
  static constexpr int kTailAt = -1;  // the tail reads the whole records
  User user;

  __host__ __device__ UserScore(const double (&p)[4]) : user(p) {}

  __device__ __forceinline__ T operator()(const T* r1, const T* c1,
                                          const T* r2, const T* c2) const {
    return user(r1, c1, r2, c2);
  }
  __device__ __forceinline__ bool screen(const T* r1, const T* c1,
                                         const T* r2, const T* c2,
                                         T& v) const {
    if constexpr (kScreen)
      return user.screen(r1, c1, r2, c2, v);
    else
      return true;
  }
  __device__ __forceinline__ bool gate(const T* r1, const T* c1,
                                       const T* r2, const T* c2,
                                       T& v) const {
    if constexpr (kSplit) {
      return user.gate(r1, c1, r2, c2, v);
    } else {
      v = user(r1, c1, r2, c2);
      return true;
    }
  }
  __device__ __forceinline__ T tail(const T* r1, const T* c1, const T* r2,
                                    const T* c2, T v) const {
    if constexpr (kSplit)
      return user.tail(r1, c1, r2, c2, v);
    else
      return v;
  }
};
