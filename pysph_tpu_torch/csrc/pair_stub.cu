// The WCSPH pair kernel's walk and loads with its arithmetic taken out,
// for Hopper (sm_90a).
//
// Replaces the zero-writing stubs that tools_dev/prof_dma.py::stub_kern
// and tools_dev/prof_phases.py::stub_kern put in place of the engine's
// Pallas kernel: the same inputs are moved in, every output is written as
// 0, and the time tells data movement apart from arithmetic.  On a GPU
// the inputs are not copied in ahead of the body; the kernel's own loads
// are the data movement, so this kernel takes csrc/wcsph_pair.cu's
// arguments (WcsphArgs, with the sources' packed copies), makes the loads
// of the mode it is given and writes 0 to every output:
//
//   all    wcsph_pair's walk (csrc/cell_walk.cuh): threads in the dest's
//          sorted order, each lane walking its cells cx - 1 .. cx + 1 in
//          every stencil row of every source (the packed copy, launched
//          first as wcsph_pair launches it), with its loads: the dest's
//          order and cell, the row
//          spans, the {x y z h} record of every candidate, and the {u v w
//          m} and, where the term mask reads rho, {rho p cs} records of
//          every pair in support.  The support test r2 < (rs max(hi,
//          hj))^2 stays, since it decides which loads the kernel makes;
//          the fold of those records takes the place of the pair body,
//          in the walker's rounds.  The counterpart of the TPU tool's
//          "stub (all inputs)";
//   third  the same walk over the lane's own cell cx only, in every
//          stencil row: one x offset of three (the TPU tool keeps views
//          1, 4 and 7 of each 9);
//   dest   the dest's props only (as wcsph_pair reads them), no walk;
//   none   no loads.
//
// Every loaded value is folded into one sum per dest, which is written
// to `sink` only under the runtime flag `write_sink`.  The wrapper never
// sets it, but the compiler cannot know that, so the loads stay (the
// mode is a template argument, so the SASS of each instance shows them).
//
// What bounds it: in `all` mode the loads of wcsph_pair.cu's walk (one
// record per candidate, one or two more per pair in support), with 12
// flops per candidate; in `none` only the stores, so its time is a
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

enum Mode { kNone, kDestOnly, kThird, kAll };

template <typename T, int MODE>
__global__ void __launch_bounds__(128) pair_stub_kernel(const StubArgs sa) {
  const WcsphArgs& a = sa.a;
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pos < a.n_dest;
  // the walk's threads follow the dest's sorted order; without a walk,
  // thread i takes row i and reads no index
  int i = pos;
  T acc = T(0);
  if (MODE < kThird && !active) return;
  if (MODE >= kThird) i = active ? a.dorder[pos] : 0;
  Dest<T> d{};
  if (MODE >= kDestOnly && active) {
    d.load(a, i, wcsph::dest_terms(a));
    acc = d.xi + d.yi + d.zi + d.ui + d.vi + d.wi + d.hi + d.rhoi + d.pi +
          d.csi + d.cfl;
  }
  if (MODE >= kThird) {
    const T rs = T(a.radius_scale);
    const walk::Lane l =
        walk::lane_cell(a, active ? a.cell[i] : 0, active);
    walk::Walker<T> walker;
    walker.begin();
    for (int s = 0; s < a.n_src; ++s) {
      const SrcArgs& S = a.src[s];
      const bool thermo = S.terms & (kMom | kXsph), mom = S.terms & kMom;
      auto fold = [&](int k) {
        const wcsph::Rec<T> v = wcsph::rec<T>(S.vel, k);
        acc += v.a + v.b + v.c + v.d;
        if (thermo) {
          const wcsph::Rec<T> t = wcsph::rec<T>(S.thermo, k);
          acc += t.a;
          if (mom) acc += t.b + t.c;
        }
      };
      wcsph::walk_rows(a, S, l, MODE == kAll ? 1 : 0, d, rs, walker,
                       fold);
      walker.finish(fold);
    }
    if (!active) return;
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
  if (!wcsph::args_ok(sa.a) || (sa.write_sink && sa.sink == nullptr) ||
      (sa.mode >= kThird &&
       (sa.a.dorder == nullptr || sa.a.cell == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sa.a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(sa.a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(sa.a.dtype == 0 ? launch<float>(sa, st)
                                           : launch<double>(sa, st));
}

const char* pair_stub_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
