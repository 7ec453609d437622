// CRKSPHPreStep's post_loop solve for Hopper (sm_90a): from each
// particle's reproducing-kernel moments the correction's A_i, grad A_i,
// B_i and grad B_i, in closed form, one thread a particle.
//
// Replaces no Pallas kernel: the JAX package computes the solve in jnp
// (pysph_tpu/sph/wc/crksph.py:86-130, jnp.linalg.det and inv), and the
// port's plain version is ~30 batched torch ops (ops/crk_solve.py
// crk_solve_reference), which took ~0.7 ms a step at the accuracy test's
// 65,536 particles on an H100, beside a few microseconds of memory
// traffic.  As the plain version: m2's determinant and inverse from the
// cofactors (the inverse adj / det), a particle whose |det m2| < 1e-14
// solved on the identity, c = m2^-1 m1, A = 1 / (m0 - c.m1), B = -c,
// grad A = -A^2 (gm0 - m2^-1 m1 gm1 - m1 m2^-1 gm1 + gm2 c c), grad B =
// -m2^-1 gm1 + m2^-1 gm2 c; a particle that is singular or has fewer than
// 2 neighbours (nnbr) gets A = 1 and zeros.  DIM 1, 2 or 3 (a template
// parameter), float32 and float64.
//
// Built with -fmad=false (ops/build.py EXTRA_FLAGS): the determinant
// rounds as the plain version's products and differences, so the same
// particles are singular.
//
// What bounds it: bytes, ~(2 + 2 DIM + 2 DIM^2 + DIM^3) values read and
// (1 + 2 DIM + DIM^2) written a particle.
//
// Interface: plain C, called through ctypes (ops/crk_solve.py).  The
// moments are rows of their strided props, each row's first values
// d-packed (m1[a], m2[DIM a + b], gm0[g], gm1[DIM g + a], gm2[DIM DIM g +
// DIM a + b]) at a row stride of its own; the outputs are contiguous: ai
// (n), gradai (n, DIM), bi (n, DIM), gradbi (n, DIM, DIM) [g][a].

#include <cuda_runtime.h>
#include <stdint.h>

struct SolveArgs {
  const void *m0, *m1, *m2, *gm0, *gm1, *gm2, *nnbr;
  void *ai, *gradai, *bi, *gradbi;
  // each moment's row stride, in values
  int64_t s_m0, s_m1, s_m2, s_gm0, s_gm1, s_gm2, s_nnbr;
  int32_t n, dim, dtype;
};

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T ld(const void* p, int64_t k) {
  return static_cast<const T*>(p)[k];
}

// det of the D x D matrix m, as crk_solve_reference's _inverse
template <typename T, int D>
__device__ __forceinline__ T det_of(const T (&m)[D][D]) {
  if constexpr (D == 1) {
    return m[0][0];
  } else if constexpr (D == 2) {
    return m[0][0] * m[1][1] - m[0][1] * m[1][0];
  } else {
    T cof[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      cof[j] = m[1][(j + 1) % 3] * m[2][(j + 2) % 3] -
               m[1][(j + 2) % 3] * m[2][(j + 1) % 3];
    return m[0][0] * cof[0] + m[0][1] * cof[1] + m[0][2] * cof[2];
  }
}

// the inverse of m (det its determinant): the adjugate over det
template <typename T, int D>
__device__ __forceinline__ void inverse_of(const T (&m)[D][D], T det,
                                           T (&inv)[D][D]) {
  if constexpr (D == 1) {
    inv[0][0] = T(1) / m[0][0];
  } else if constexpr (D == 2) {
    inv[0][0] = m[1][1] / det;
    inv[0][1] = -m[0][1] / det;
    inv[1][0] = -m[1][0] / det;
    inv[1][1] = m[0][0] / det;
  } else {
    // inv[i][j] = cof[j][i] / det
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
        const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
        inv[i][j] = (m[j1][i1] * m[j2][i2] - m[j1][i2] * m[j2][i1]) / det;
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) crk_solve_kernel(
    const SolveArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const T m0 = ld<T>(a.m0, i * a.s_m0);
  const T nnbr = ld<T>(a.nnbr, i * a.s_nnbr);
  T m1[D], gm0[D], m2[D][D], gm1[D][D], gm2[D][D][D];
#pragma unroll
  for (int p = 0; p < D; ++p) {
    m1[p] = ld<T>(a.m1, i * a.s_m1 + p);
    gm0[p] = ld<T>(a.gm0, i * a.s_gm0 + p);
#pragma unroll
    for (int q = 0; q < D; ++q) {
      m2[p][q] = ld<T>(a.m2, i * a.s_m2 + D * p + q);
      gm1[p][q] = ld<T>(a.gm1, i * a.s_gm1 + D * p + q);
#pragma unroll
      for (int r = 0; r < D; ++r)
        gm2[p][q][r] = ld<T>(a.gm2, i * a.s_gm2 + D * D * p + D * q + r);
    }
  }
  // the system of a singular particle is the identity's
  const bool singular = fabs(det_of<T, D>(m2)) < T(1e-14);
  if (singular) {
#pragma unroll
    for (int p = 0; p < D; ++p)
#pragma unroll
      for (int q = 0; q < D; ++q) m2[p][q] = T(p == q);
  }
  T inv[D][D];
  inverse_of<T, D>(m2, det_of<T, D>(m2), inv);
  T c[D];
  T cm = T(0);
#pragma unroll
  for (int p = 0; p < D; ++p) {
    c[p] = T(0);
#pragma unroll
    for (int q = 0; q < D; ++q) c[p] += inv[p][q] * m1[q];
    cm += c[p] * m1[p];
  }
  const T ai = T(1) / (m0 - cm);
  const bool bad = singular || nnbr < T(2);
  T* gradai = static_cast<T*>(a.gradai) + size_t(i) * D;
  T* bi = static_cast<T*>(a.bi) + size_t(i) * D;
  T* gradbi = static_cast<T*>(a.gradbi) + size_t(i) * D * D;
  static_cast<T*>(a.ai)[i] = bad ? T(1) : ai;
#pragma unroll
  for (int g = 0; g < D; ++g) {
    // t1 = gm0 - m2^-1 m1 gm1 - m1 m2^-1 gm1 + gm2 c c
    T t1 = gm0[g];
#pragma unroll
    for (int p = 0; p < D; ++p)
#pragma unroll
      for (int q = 0; q < D; ++q)
        t1 -= inv[p][q] * m1[q] * gm1[g][p] + inv[p][q] * m1[p] * gm1[g][q];
#pragma unroll
    for (int f = 0; f < D; ++f)
#pragma unroll
      for (int s = 0; s < D; ++s) t1 += gm2[g][f][s] * c[f] * c[s];
    gradai[g] = bad ? T(0) : -ai * ai * t1;
    bi[g] = bad ? T(0) : -c[g];
#pragma unroll
    for (int p = 0; p < D; ++p) {
      // gradbi[g][p] = -(m2^-1 gm1)[p] + (m2^-1 gm2 c)[p]
      T v = T(0);
#pragma unroll
      for (int q = 0; q < D; ++q) {
        T gc = T(0);
#pragma unroll
        for (int s = 0; s < D; ++s) gc += gm2[g][q][s] * c[s];
        v += inv[p][q] * (gc - gm1[g][q]);
      }
      gradbi[D * g + p] = bad ? T(0) : v;
    }
  }
}

template <typename T>
cudaError_t launch(const SolveArgs& a, cudaStream_t stream) {
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (a.dim == 1)
    crk_solve_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(a);
  else if (a.dim == 2)
    crk_solve_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(a);
  else
    crk_solve_kernel<T, 3><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool args_ok(const SolveArgs& a) {
  return a.m0 && a.m1 && a.m2 && a.gm0 && a.gm1 && a.gm2 && a.nnbr &&
         a.ai && a.gradai && a.bi && a.gradbi && a.n >= 0 && a.dim >= 1 &&
         a.dim <= 3 && (a.dtype == 0 || a.dtype == 1);
}

}  // namespace

extern "C" {

int crk_solve_args_size() { return static_cast<int>(sizeof(SolveArgs)); }

int crk_solve_launch(const SolveArgs* args, void* stream) {
  const SolveArgs& a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                       : launch<double>(a, st));
}

const char* crk_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
