// The smoothing kernels' unnormalised shape functions (w, dw/dq) of
// base/kernels.py, by KERNEL_KIND: WendlandQuintic 0, CubicSpline 1,
// Gaussian 2 and QuinticSpline 3.  Every pair kernel that computes WIJ or
// DWIJ takes its shape from here (csrc/wcsph_terms.cuh names it
// wcsph::shape); the kernel's sigma and 1 / h^dim are the caller's.

#pragma once

#include <cuda_runtime.h>

namespace shapes {

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

}  // namespace shapes
