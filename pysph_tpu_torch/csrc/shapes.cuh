// The smoothing kernels' unnormalised shape functions (w, dw/dq) of
// base/kernels.py, by kernel_kind: WendlandQuintic 0, CubicSpline 1,
// Gaussian 2, QuinticSpline 3, WendlandQuinticC4 4, WendlandQuinticC6 5,
// SuperGaussian 6 in 2D and 7 in 3D (its shape depends on dim, so each dim
// is a kind).  Every pair kernel that computes WIJ or DWIJ takes its shape
// from here (csrc/wcsph_terms.cuh names it wcsph::shape); the kernel's
// sigma and 1 / h^dim are the caller's.  gradient_h gives dW/dh from a
// shape (csrc/gasd_pair.cu's GHI).
//
// The libraries (ops/build.py).  A pair kernel instantiates its templates
// once a kind, so each kind adds to its cold build.  A library built
// without PAIR_KIND holds kinds 0-3, the kinds of the paths it had before
// the later ones; a library built with -DPAIR_KIND=k holds kind k alone,
// and ops/build.py builds one for each later kind at its first launch.
// with_kind(kind, f) calls f with the kind as a compile-time constant,
// over the kinds the library holds; built_kind(kind) says whether it
// holds it.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace shapes {

// the kinds of a library built without PAIR_KIND
constexpr int kBaseKinds = 4;
// kinds in all
constexpr int kKinds = 8;

inline bool built_kind(int kind) {
#ifdef PAIR_KIND
  return kind == PAIR_KIND;
#else
  return kind >= 0 && kind < kBaseKinds;
#endif
}

// f(std::integral_constant<int, kind>) for a kind this library holds
// (built_kind); the caller checks the kind first.
template <class F>
auto with_kind(int kind, F&& f) {
#ifdef PAIR_KIND
  (void)kind;
  return f(std::integral_constant<int, PAIR_KIND>());
#else
  switch (kind) {
    case 0:
      return f(std::integral_constant<int, 0>());
    case 1:
      return f(std::integral_constant<int, 1>());
    case 2:
      return f(std::integral_constant<int, 2>());
    default:
      return f(std::integral_constant<int, 3>());
  }
#endif
}

template <typename T, int KIND>
__device__ __forceinline__ void shape(T q, T& w, T& dw) {
  if (KIND == 0) {  // WendlandQuintic, support q < 2
    if (q < T(2)) {
      const T t = T(1) - T(0.5) * q;
      const T t3 = t * t * t;
      w = t3 * t * (T(2) * q + T(1));
      dw = T(-5) * q * t3;
    } else {
      w = T(0);
      dw = T(0);
    }
  } else if (KIND == 1) {  // CubicSpline, support q <= 2
    if (q > T(2)) {
      w = T(0);
      dw = T(0);
    } else if (q > T(1)) {
      const T t = T(2) - q;
      w = T(0.25) * t * t * t;
      dw = T(-0.75) * t * t;
    } else {
      w = T(1) - T(1.5) * q * q * (T(1) - T(0.5) * q);
      dw = T(-3) * q * (T(1) - T(0.75) * q);
    }
  } else if (KIND == 2) {  // Gaussian, truncated at q = 3 (exp, not __expf)
    if (q < T(3)) {
      const T e = exp(-q * q);
      w = e;
      dw = T(-2) * q * e;
    } else {
      w = T(0);
      dw = T(0);
    }
  } else if (KIND == 4) {  // WendlandQuinticC4, support q < 2
    if (q < T(2)) {
      const T t = T(1) - T(0.5) * q;
      const T t2 = t * t, t5 = t2 * t2 * t;
      w = t5 * t * ((T(35) / T(12)) * q * q + T(3) * q + T(1));
      dw = (T(-14) / T(3)) * q * (T(1) + T(2.5) * q) * t5;
    } else {
      w = T(0);
      dw = T(0);
    }
  } else if (KIND == 5) {  // WendlandQuinticC6, support q < 2
    if (q < T(2)) {
      const T t = T(1) - T(0.5) * q;
      const T t2 = t * t, t4 = t2 * t2, t7 = t4 * t2 * t;
      const T q2 = q * q;
      w = t7 * t * (T(4) * q2 * q + T(6.25) * q2 + T(4) * q + T(1));
      dw = T(-5.5) * q * t7 * (T(1) + T(3.5) * q + T(4) * q2);
    } else {
      w = T(0);
      dw = T(0);
    }
  } else if (KIND == 6 || KIND == 7) {  // SuperGaussian in 2D, 3D; q < 3
    if (q < T(3)) {
      const T d = KIND == 6 ? T(2) : T(3);
      const T q2 = q * q;
      const T e = exp(-q2);
      w = e * (T(1) + T(0.5) * d - q2);
      dw = q * (T(2) * q2 - d - T(4)) * e;
    } else {
      w = T(0);
      dw = T(0);
    }
  } else {  // QuinticSpline, support q <= 3
    if (q > T(3)) {
      w = T(0);
      dw = T(0);
    } else {
      const T t3 = T(3) - q, t3_2 = t3 * t3, t3_4 = t3_2 * t3_2;
      w = t3_4 * t3;
      dw = T(-5) * t3_4;
      if (q <= T(2)) {
        const T t2 = T(2) - q, t2_2 = t2 * t2, t2_4 = t2_2 * t2_2;
        w -= T(6) * (t2_4 * t2);
        dw += T(30) * t2_4;
        if (q <= T(1)) {
          const T t1 = T(1) - q, t1_2 = t1 * t1, t1_4 = t1_2 * t1_2;
          w += T(15) * (t1_4 * t1);
          dw += T(-75) * t1_4;
        }
      }
    }
  }
}

// dW/dh of the kernel at q = r / h from its shape (w, dw) at q, where fac
// is sigma / h^dim and h1 is 1 / h: -fac / h (q dw + dim w), as
// base/kernels.py gradient_h (and the torch pair engine's GHI, GHJ, GHIJ).
template <typename T>
__device__ __forceinline__ T gradient_h(T w, T dw, T q, T fac, T h1,
                                        int dim) {
  return -fac * h1 * (dw * q + w * T(dim));
}

}  // namespace shapes
