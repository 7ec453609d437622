// The packed, cell-sorted copy of the sources of one pair call, for Hopper
// (sm_90a).
//
// csrc/wcsph_pair.cu, csrc/dense_pair.cu and csrc/pair_stub.cu read each
// source through this copy: position k holds particle order[k], as
// records of four values of the working type,
//
//   record plane 0: {x, y, z, h}      every candidate's support test
//   record plane 1: {u, v, w, m}      every pair in support
//   record plane 2: {rho, p, cs, 0}   where the term mask reads rho (p and
//                                     cs 0 where it reads neither)
//
// so that a walk reads one 16-byte (float) or 32-byte (double) record
// where it read an index and four scattered values, and the particles of
// x-adjacent cells of a row are one contiguous, aligned span that the
// bulk copy can stage.  The JAX package's counterpart is the resident
// engine's pack (pysph_tpu/ops/resident.py::build_pack, an XLA gather).
// One launch packs every source of a call (grid y: the source); a copy
// is made for each call, since a dest's initialize/post_loop between two
// calls may change a source prop.
//
// The walks' launch functions launch the pack themselves, just before
// the walk on the same stream (WcsphArgs::pack), so a call costs the host
// one launch through ctypes; csrc/cell_pack.cu exports it alone.
//
// What bounds it: bytes; each value is read once through order (a
// gather) and written once, coalesced.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxPackSources = 4;

struct PackSrc {
  // rho null: two record planes; p and cs null: written as 0
  const void *x, *y, *z, *h, *u, *v, *w, *m, *rho, *p, *cs;
  const int32_t* order;
  void* out;  // (planes, n, 4) of the dtype
  int32_t n, planes;
};

// n_src 0: nothing to pack
struct PackArgs {
  PackSrc src[kMaxPackSources];
  int32_t n_src, dtype;
};

namespace pack {

template <typename T>
__device__ __forceinline__ T value(const void* p, int j) {
  return p == nullptr ? T(0) : static_cast<const T*>(p)[j];
}

__device__ __forceinline__ void store(float* plane, int k, float a, float b,
                                      float c, float d) {
  reinterpret_cast<float4*>(plane)[k] = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store(double* plane, int k, double a,
                                      double b, double c, double d) {
  double2* q = reinterpret_cast<double2*>(plane) + 2 * k;
  q[0] = make_double2(a, b);
  q[1] = make_double2(c, d);
}

template <typename T>
__global__ void __launch_bounds__(256) cell_pack_kernel(const PackArgs a) {
  const PackSrc& S = a.src[blockIdx.y];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= S.n) return;
  const int j = S.order[k];
  T* out = static_cast<T*>(S.out);
  const size_t plane = static_cast<size_t>(S.n) * 4;
  store(out, k, value<T>(S.x, j), value<T>(S.y, j), value<T>(S.z, j),
        value<T>(S.h, j));
  store(out + plane, k, value<T>(S.u, j), value<T>(S.v, j),
        value<T>(S.w, j), value<T>(S.m, j));
  if (S.planes == 3)
    store(out + 2 * plane, k, value<T>(S.rho, j), value<T>(S.p, j),
          value<T>(S.cs, j), T(0));
}

inline bool args_ok(const PackArgs& a) {
  if (a.n_src < 0 || a.n_src > kMaxPackSources ||
      (a.dtype != 0 && a.dtype != 1))
    return false;
  for (int s = 0; s < a.n_src; ++s) {
    const PackSrc& S = a.src[s];
    if (S.n < 0 || (S.planes != 2 && S.planes != 3) ||
        (S.n > 0 && (S.order == nullptr || S.out == nullptr)))
      return false;
  }
  return true;
}

// One launch for every source of `a` (none where no source has a
// particle); `a` must pass args_ok.
inline cudaError_t launch(const PackArgs& a, cudaStream_t stream) {
  int n = 0;
  for (int s = 0; s < a.n_src; ++s) n = a.src[s].n > n ? a.src[s].n : n;
  if (n == 0) return cudaSuccess;
  const dim3 blocks((n + 255) / 256, a.n_src);
  if (a.dtype == 0)
    cell_pack_kernel<float><<<blocks, 256, 0, stream>>>(a);
  else
    cell_pack_kernel<double><<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace pack
