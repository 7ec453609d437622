// Cell-blocked WCSPH pair kernel for Hopper (sm_90a).
//
// Replaces pysph_tpu/ops/pallas_engine.py::_pair_kernel (the dense-slot
// Pallas engine, PYSPH_TPU_RESIDENT=0 PYSPH_TPU_COMPACT=0) for the WCSPH
// phase sets: ContinuityEquation, the non-tensile MomentumEquation and
// XSPHCorrection of one dest array over at most 4 sources, with the
// WendlandQuintic, CubicSpline or Gaussian kernel.  Same contract, same
// arguments and same per-pair body (wcsph_terms.cuh) as
// csrc/wcsph_pair.cu; only the walk differs.
//
// The TPU kernel gives one program to each active cell block, runs the
// 9 neighbour views and every fused source inside it, accumulates in
// VMEM scratch and writes each output once.  The GPU form of that:
//
// - one thread block per dest cell; the cell's dest particles, taken
//   through the dest's sorted order[start:end), a tile of kThreads at a
//   time, one thread each;
// - for each source and each of the 3^dim neighbour cells, the block
//   stages the source particles' props into shared memory, a chunk of
//   kThreads at a time (so a cell of any occupancy fits, including the
//   fat edge cells into which CellGrid clamps particles that left the
//   initial extent), with __syncthreads() between chunks; every dest
//   thread of the tile then walks the chunk;
// - each dest accumulates in registers over every source and writes
//   pre + sum (max(pre, m) for dt_cfl) once, under the write mask.  No
//   atomics: runs repeat exactly.
//
// What bounds it: wcsph_pair.cu gathers each candidate's 8-11 values
// once per dest that sees it (27 cells x ~18 particles in 3D); here a
// block loads them once per dest tile, coalesced through the sorted
// order, and the walk reads shared memory.  The cost is occupancy: at
// ~15 particles a cell (the 2D elliptical drop at nx=200) most of the 64
// threads of a block idle during the walk, and every block of an empty
// cell starts and stops.  kThreads = 64 (two warps) keeps 32 resident
// blocks an SM at full thread occupancy; tuning it, or packing several
// cells into a block, is later work.
//
// Interface: plain C through ctypes (ops/dense_pair.py), as wcsph_pair.

#include "wcsph_terms.cuh"

namespace {

using wcsph::Dest;

constexpr int kThreads = 64;
// shared-memory planes of a staged chunk
enum { kX, kY, kZ, kU, kV, kW, kH, kM, kRho, kP, kCs, kPlanes };

// A chunk of source particles in shared memory, read by position.
template <typename T>
struct SharedSrc {
  const T* sm;
  __device__ T x(int k) const { return sm[kX * kThreads + k]; }
  __device__ T y(int k) const { return sm[kY * kThreads + k]; }
  __device__ T z(int k) const { return sm[kZ * kThreads + k]; }
  __device__ T u(int k) const { return sm[kU * kThreads + k]; }
  __device__ T v(int k) const { return sm[kV * kThreads + k]; }
  __device__ T w(int k) const { return sm[kW * kThreads + k]; }
  __device__ T h(int k) const { return sm[kH * kThreads + k]; }
  __device__ T m(int k) const { return sm[kM * kThreads + k]; }
  __device__ T rho(int k) const { return sm[kRho * kThreads + k]; }
  __device__ T p(int k) const { return sm[kP * kThreads + k]; }
  __device__ T cs(int k) const { return sm[kCs * kThreads + k]; }
};

template <typename T>
__device__ __forceinline__ void stage(T* sm, int plane, const void* src,
                                      int j) {
  sm[plane * kThreads + threadIdx.x] = wcsph::ld<T>(src, j);
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
    dense_pair_kernel(const WcsphArgs a) {
  __shared__ T sm[kPlanes * kThreads];
  const SharedSrc<T> chunk{sm};

  const int c = blockIdx.x;
  const int dstart = a.dcell_start[c], dend = a.dcell_end[c];
  if (dstart >= dend) return;  // the same for every thread of the block

  const int cx = c % a.nx, cy = (c / a.nx) % a.ny, cz = c / (a.nx * a.ny);
  const int rx = a.nx > 1, ry = a.ny > 1, rz = a.nz > 1;
  const int dterms = wcsph::dest_terms(a);
  const T rs = T(a.radius_scale), kfac = T(a.kfac);

  for (int base = dstart; base < dend; base += kThreads) {
    const int pos = base + threadIdx.x;
    const bool active = pos < dend;
    const int i = active ? a.dorder[pos] : 0;
    Dest<T> d;
    if (active) d.load(a, i, dterms);

    for (int s = 0; s < a.n_src; ++s) {
      const SrcArgs& S = a.src[s];
      const int terms = S.terms;
      const bool rho = terms & (kMom | kXsph), mom = terms & kMom;
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
            for (int k0 = S.cell_start[nc]; k0 < kend; k0 += kThreads) {
              const int cnt = min(kThreads, kend - k0);
              __syncthreads();  // the last chunk's readers are done
              if (threadIdx.x < cnt) {
                const int j = S.order[k0 + threadIdx.x];
                stage<T>(sm, kX, S.x, j);
                stage<T>(sm, kY, S.y, j);
                stage<T>(sm, kZ, S.z, j);
                stage<T>(sm, kU, S.u, j);
                stage<T>(sm, kV, S.v, j);
                stage<T>(sm, kW, S.w, j);
                stage<T>(sm, kH, S.h, j);
                stage<T>(sm, kM, S.m, j);
                if (rho) stage<T>(sm, kRho, S.rho, j);
                if (mom) {
                  stage<T>(sm, kP, S.p, j);
                  stage<T>(sm, kCs, S.cs, j);
                }
              }
              __syncthreads();
              if (active)
                for (int k = 0; k < cnt; ++k)
                  d.template pair<KIND>(chunk, k, terms, c0, alpha, beta,
                                        xeps, rs, kfac, a.dim);
            }
          }
        }
      }
    }
    if (active) d.store(a, i);
  }
}

template <typename T>
cudaError_t launch(const WcsphArgs& a, cudaStream_t stream) {
  const long long cells = 1LL * a.nx * a.ny * a.nz;
  if (cells > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(cells);
  if (a.kernel_kind == 0)
    dense_pair_kernel<T, 0><<<blocks, kThreads, 0, stream>>>(a);
  else if (a.kernel_kind == 1)
    dense_pair_kernel<T, 1><<<blocks, kThreads, 0, stream>>>(a);
  else
    dense_pair_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dense_pair_args_size() { return static_cast<int>(sizeof(WcsphArgs)); }

int dense_pair_launch(const WcsphArgs* args, void* stream) {
  const WcsphArgs a = *args;
  if (!wcsph::args_ok(a) || a.dorder == nullptr ||
      a.dcell_start == nullptr || a.dcell_end == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* dense_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
