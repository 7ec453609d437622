// WCSPH pair kernel for Hopper (sm_90a).
//
// Replaces pysph_tpu/ops/resident.py::_pair_kernel_resident for the
// equations of the dam-break main path: ContinuityEquation, the
// non-tensile MomentumEquation (artificial viscosity and the dt_cfl max)
// and XSPHCorrection, with the WendlandQuintic, CubicSpline or Gaussian
// kernel.
// One launch computes every pair term of one dest array over all of its
// sources (at most 4), and writes each output once.
//
// What bounds it: per candidate pair it loads 8-11 source values through
// the cell-sorted index, scattered over memory, against some 60-100
// flops; on an H100 the neighbour gather (L2 and DRAM traffic, latency),
// not arithmetic, is the limit.
//
// Design: one thread per dest particle.  The thread walks the 3^dim
// cells around its own cell in each source's sorted cell list, applies
// the support test r2 < (rs max(hi, hj))^2, computes the pair symbols
// with the guards of the torch pair engine, and accumulates in
// registers.  No atomics and no cross-thread reduction are needed, so
// the result is the same on every run.  The per-pair body, the shape
// functions and the argument struct are in wcsph_terms.cuh, shared with
// csrc/dense_pair.cu, which walks the same cells with one block per
// dest cell and the source cells staged in shared memory.
//
// Interface: plain C, called through ctypes (ops/wcsph_pair.py).  The
// launch function takes a host pointer to WcsphArgs (copied into the
// kernel's parameters) and the stream, and returns cudaGetLastError().

#include "wcsph_terms.cuh"

namespace {

using wcsph::Dest;
using wcsph::GlobalSrc;

template <typename T, int KIND>
__global__ void __launch_bounds__(128)
    wcsph_pair_kernel(const WcsphArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_dest) return;

  Dest<T> d;
  d.load(a, i, wcsph::dest_terms(a));
  const T rs = T(a.radius_scale), kfac = T(a.kfac);

  const int c = a.cell[i];
  const int cx = c % a.nx, cy = (c / a.nx) % a.ny, cz = c / (a.nx * a.ny);
  const int rx = a.nx > 1, ry = a.ny > 1, rz = a.nz > 1;

  for (int s = 0; s < a.n_src; ++s) {
    const SrcArgs& S = a.src[s];
    const GlobalSrc<T> src{S};
    const int terms = S.terms;
    const T c0 = T(S.c0), alpha = T(S.alpha), beta = T(S.beta);
    const T xeps = T(S.xsph_eps);
    for (int oz = -rz; oz <= rz; ++oz) {
      const int z = cz + oz;
      if (z < 0 || z >= a.nz) continue;
      for (int oy = -ry; oy <= ry; ++oy) {
        const int y = cy + oy;
        if (y < 0 || y >= a.ny) continue;
        for (int ox = -rx; ox <= rx; ++ox) {
          const int x = cx + ox;
          if (x < 0 || x >= a.nx) continue;
          const int nc = x + a.nx * (y + a.ny * z);
          const int kend = S.cell_end[nc];
          for (int k = S.cell_start[nc]; k < kend; ++k)
            d.template pair<KIND>(src, S.order[k], terms, c0, alpha, beta,
                                  xeps, rs, kfac, a.dim);
        }
      }
    }
  }
  d.store(a, i);
}

template <typename T>
cudaError_t launch(const WcsphArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.n_dest + threads - 1) / threads;
  if (a.kernel_kind == 0)
    wcsph_pair_kernel<T, 0><<<blocks, threads, 0, stream>>>(a);
  else if (a.kernel_kind == 1)
    wcsph_pair_kernel<T, 1><<<blocks, threads, 0, stream>>>(a);
  else
    wcsph_pair_kernel<T, 2><<<blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int wcsph_pair_args_size() { return static_cast<int>(sizeof(WcsphArgs)); }

int wcsph_pair_launch(const WcsphArgs* args, void* stream) {
  const WcsphArgs a = *args;
  if (!wcsph::args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* wcsph_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
