// The WCSPH pair kernel's walk and loads with its arithmetic taken out,
// for Hopper (sm_90a).
//
// Replaces the zero-writing stubs that tools_dev/prof_dma.py::stub_kern
// and tools_dev/prof_phases.py::stub_kern put in place of the engine's
// Pallas kernel: the same inputs are moved in, every output is written as
// 0, and the time tells data movement apart from arithmetic.  On a GPU
// the inputs are not copied in ahead of the body; the kernel's own loads
// are the data movement, so this kernel takes csrc/wcsph_pair.cu's
// arguments (WcsphArgs), makes the loads of the mode it is given and
// writes 0 to every output:
//
//   all    wcsph_pair's walk of the 3^dim cells of every source, with its
//          loads: the cell ranges, the sorted order, x y z h of every
//          candidate, and the props its term mask reads (u v w m, rho,
//          p cs) of every pair in support.  The support test
//          r2 < (rs max(hi, hj))^2 stays, since it decides which loads
//          the kernel makes; the pair arithmetic after it goes.  The
//          counterpart of the TPU tool's "stub (all inputs)";
//   third  the same, over the cells at the dest's own x only (3^(dim-1)
//          of the 3^dim): the TPU tool keeps views 1, 4 and 7 of each 9;
//   dest   the dest's props only (as wcsph_pair reads them), no walk;
//   none   no loads.
//
// Every loaded value is folded into one sum per dest, which is written
// to `sink` only under the runtime flag `write_sink`.  The wrapper never
// sets it, but the compiler cannot know that, so the loads stay (the
// mode is a template argument, so the SASS of each instance shows them).
//
// What bounds it: in `all` mode the same gather as wcsph_pair.cu (4
// values per candidate, 4-7 more per pair in support, scattered), with
// 12 flops per candidate; in `none` only the stores, so its time is a
// launch and the output bytes.
//
// Interface: plain C through ctypes (ops/pair_stub.py).  pair_stub_launch
// takes a host pointer to StubArgs and the stream, and returns
// cudaGetLastError().

#include "wcsph_terms.cuh"

struct StubArgs {
  WcsphArgs a;
  void* sink;  // (n_dest,) of the dtype: the folded loads, if write_sink
  int32_t mode, write_sink;
};

namespace {

using wcsph::Dest;
using wcsph::GlobalSrc;

enum Mode { kNone, kDestOnly, kThird, kAll };

template <typename T, int MODE>
__global__ void __launch_bounds__(128) pair_stub_kernel(const StubArgs sa) {
  const WcsphArgs& a = sa.a;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_dest) return;

  T acc = T(0);
  if (MODE >= kDestOnly) {
    Dest<T> d;
    d.load(a, i, wcsph::dest_terms(a));
    acc = d.xi + d.yi + d.zi + d.ui + d.vi + d.wi + d.hi + d.rhoi + d.pi +
          d.csi + d.cfl;
    if (MODE >= kThird) {
      const T rs = T(a.radius_scale);
      const int c = a.cell[i];
      const int cx = c % a.nx, cy = (c / a.nx) % a.ny, cz = c / (a.nx * a.ny);
      const int rx = a.nx > 1, ry = a.ny > 1, rz = a.nz > 1;
      const int ox0 = MODE == kAll ? -rx : 0, ox1 = MODE == kAll ? rx : 0;
      for (int s = 0; s < a.n_src; ++s) {
        const SrcArgs& S = a.src[s];
        const GlobalSrc<T> src{S};
        const bool rho = S.terms & (kMom | kXsph), mom = S.terms & kMom;
        for (int oz = -rz; oz <= rz; ++oz) {
          const int z = cz + oz;
          if (z < 0 || z >= a.nz) continue;
          for (int oy = -ry; oy <= ry; ++oy) {
            const int y = cy + oy;
            if (y < 0 || y >= a.ny) continue;
            for (int ox = ox0; ox <= ox1; ++ox) {
              const int x = cx + ox;
              if (x < 0 || x >= a.nx) continue;
              const int nc = x + a.nx * (y + a.ny * z);
              const int kend = S.cell_end[nc];
              for (int k = S.cell_start[nc]; k < kend; ++k) {
                const int j = S.order[k];
                const T xij = d.xi - src.x(j);
                const T yij = d.yi - src.y(j);
                const T zij = d.zi - src.z(j);
                const T r2 = xij * xij + yij * yij + zij * zij;
                const T hj = src.h(j);
                const T sup = rs * (d.hi > hj ? d.hi : hj);
                if (!(r2 < sup * sup)) continue;
                acc += src.u(j) + src.v(j) + src.w(j) + src.m(j);
                if (rho) acc += src.rho(j);
                if (mom) acc += src.p(j) + src.cs(j);
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kNumOut; ++k)
    if (a.out[k] != nullptr) static_cast<T*>(a.out[k])[i] = T(0);
  if (sa.write_sink) static_cast<T*>(sa.sink)[i] = acc;
}

template <typename T>
cudaError_t launch(const StubArgs& sa, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (sa.a.n_dest + threads - 1) / threads;
  switch (sa.mode) {
    case kNone:
      pair_stub_kernel<T, kNone><<<blocks, threads, 0, stream>>>(sa);
      break;
    case kDestOnly:
      pair_stub_kernel<T, kDestOnly><<<blocks, threads, 0, stream>>>(sa);
      break;
    case kThird:
      pair_stub_kernel<T, kThird><<<blocks, threads, 0, stream>>>(sa);
      break;
    case kAll:
      pair_stub_kernel<T, kAll><<<blocks, threads, 0, stream>>>(sa);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int pair_stub_args_size() { return static_cast<int>(sizeof(StubArgs)); }

int pair_stub_launch(const StubArgs* args, void* stream) {
  const StubArgs sa = *args;
  if (!wcsph::args_ok(sa.a) || (sa.write_sink && sa.sink == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sa.a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(sa.a.dtype == 0 ? launch<float>(sa, st)
                                           : launch<double>(sa, st));
}

const char* pair_stub_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
