// The packed, cell-sorted copy of the sources of one pair call, for Hopper
// (sm_90a).
//
// Every pair kernel reads each source through this copy: position k holds
// particle order[k], as record planes of four values of the working type.
// The kernel names its planes (csrc/wcsph_terms.cuh, csrc/gtvf_pair.cu,
// csrc/fused_pair.cu; ops/cell_pack.py); plane 0 is always {x, y, z, h},
// which every candidate's support test reads.  A source packs plane 0 and
// the planes that hold a prop its terms read, and a prop the terms do not
// read is written as 0 (a null pointer here).  So a walk reads one 16-byte
// (float) or 32-byte (double) record where it read an index and four
// scattered values, and the particles of x-adjacent cells of a row are
// one contiguous, aligned span that the bulk copy can stage.  The JAX
// package's counterpart is the resident engine's pack
// (pysph_tpu/ops/resident.py::build_pack, an XLA gather).  One launch
// packs every source of a call (grid y: the source); a copy is made for
// each call, since a dest's initialize/post_loop between two calls may
// change a source prop.
//
// The walks' launch functions launch the pack themselves, just before
// the walk on the same stream (their args' `pack`), so a call costs the
// host one launch through ctypes; csrc/cell_pack.cu exports it alone.
//
// What bounds it: bytes; each value is read once through order (a
// gather) and written once, coalesced.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxPackSources = 4;
constexpr int kMaxPlanes = 10;

struct PackSrc {
  // plane q, record k: {prop[q][c][stride[q][c] * order[k]]}, c = 0..3;
  // null: written as 0.  A column of a strided prop (an (n, k) array)
  // points at its first value, with stride k.
  const void* prop[kMaxPlanes][4];
  int32_t stride[kMaxPlanes][4];
  const int32_t* order;
  void* out;  // (planes, n, 4) of the dtype
  int32_t n, planes;
};

// n_src 0: nothing to pack.  Two optional 0-d device gates, read by every
// thread (null: the plain pack):
//   run:   where it is 0 nothing is written
//   skip0: where it is set plane 0 is left as it is
// (csrc/gasd_pair.cu: the density sweep runs under its gate, and the
// momentum launch that reads the last sweep's {x y z h} packs planes 1-3).
struct PackArgs {
  PackSrc src[kMaxPackSources];
  int32_t n_src, dtype;
  const uint8_t* run;
  const uint8_t* skip0;
};

namespace pack {

template <typename T>
__device__ __forceinline__ T value(const void* p, int stride, int j) {
  return p == nullptr ? T(0)
                      : static_cast<const T*>(p)[static_cast<size_t>(j) *
                                                 stride];
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
  if (a.run != nullptr && *a.run == 0) return;
  const PackSrc& S = a.src[blockIdx.y];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= S.n) return;
  const int j = S.order[k];
  T* out = static_cast<T*>(S.out);
  const size_t plane = static_cast<size_t>(S.n) * 4;
  for (int q = a.skip0 != nullptr && *a.skip0 != 0 ? 1 : 0; q < S.planes;
       ++q)
    store(out + q * plane, k, value<T>(S.prop[q][0], S.stride[q][0], j),
          value<T>(S.prop[q][1], S.stride[q][1], j),
          value<T>(S.prop[q][2], S.stride[q][2], j),
          value<T>(S.prop[q][3], S.stride[q][3], j));
}

inline bool args_ok(const PackArgs& a) {
  if (a.n_src < 0 || a.n_src > kMaxPackSources ||
      (a.dtype != 0 && a.dtype != 1))
    return false;
  for (int s = 0; s < a.n_src; ++s) {
    const PackSrc& S = a.src[s];
    if (S.n < 0 || S.planes < 1 || S.planes > kMaxPlanes ||
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
