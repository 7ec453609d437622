// WCSPH pair kernel for Hopper (sm_90a).
//
// Replaces pysph_tpu/ops/resident.py::_pair_kernel_resident for the
// equations of the dam-break main path: ContinuityEquation, the
// non-tensile MomentumEquation (artificial viscosity and the dt_cfl max)
// and XSPHCorrection, with the WendlandQuintic or CubicSpline kernel.
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
// the result is the same on every run.  This is the simple, correct
// first version; tiling a cell's dests over a warp, staging source cells
// in shared memory and reordering particles by cell are for later.
//
// Interface: plain C, called through ctypes (ops/wcsph_pair.py).  The
// launch function takes a host pointer to WcsphArgs (copied into the
// kernel's parameters) and the stream, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// The argument structs are at global scope: the exported C functions
// take them, and a type in an unnamed namespace would give those
// functions internal linkage.
constexpr int kMaxSources = 4;
constexpr int kCont = 1, kMom = 2, kXsph = 4;
// outputs in the order of ops/wcsph_pair.py OUTPUTS: arho, au, av, aw,
// ax, ay, az, dt_cfl
constexpr int kDtCfl = 7, kNumOut = 8;

struct SrcArgs {
  const void *x, *y, *z, *u, *v, *w, *h, *m, *rho, *p, *cs;
  const int32_t* order;       // particle indices sorted by cell
  const int32_t* cell_start;  // per cell: first position in order
  const int32_t* cell_end;    // per cell: one past the last
  double c0, alpha, beta, xsph_eps;
  int32_t terms, pad;
};

struct WcsphArgs {
  const void *x, *y, *z, *u, *v, *w, *h, *rho, *p, *cs;  // dest
  const int32_t* cell;   // dest cell id, ix + nx * (iy + ny * iz)
  const uint8_t* wmask;  // write mask (bool); null: every row
  const void* pre[kNumOut];  // values before the phase; null: unused
  void* out[kNumOut];
  SrcArgs src[kMaxSources];
  double radius_scale, kfac;  // kfac: the kernel's sigma
  int32_t n_dest, n_src, nx, ny, nz, dim, kernel_kind, dtype;
};

namespace {

// Unnormalised shape function (w, dw/dq) of base/kernels.py.
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
  } else {  // CubicSpline
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
  }
}

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

template <typename T, int KIND>
__global__ void __launch_bounds__(128)
    wcsph_pair_kernel(const WcsphArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_dest) return;

  int dterms = 0;
  for (int s = 0; s < a.n_src; ++s) dterms |= a.src[s].terms;
  const bool need_rho = dterms & (kMom | kXsph);
  const bool mom = dterms & kMom;

  const T xi = ld<T>(a.x, i), yi = ld<T>(a.y, i), zi = ld<T>(a.z, i);
  const T ui = ld<T>(a.u, i), vi = ld<T>(a.v, i), wi = ld<T>(a.w, i);
  const T hi = ld<T>(a.h, i);
  const T rhoi = need_rho ? ld<T>(a.rho, i) : T(0);
  const T pi = mom ? ld<T>(a.p, i) : T(0);
  const T csi = mom ? ld<T>(a.cs, i) : T(0);
  const T rhoi21 = mom ? T(1) / (rhoi * rhoi) : T(0);
  const T rs = T(a.radius_scale), kfac = T(a.kfac);

  T arho = 0, au = 0, av = 0, aw = 0, ax = 0, ay = 0, az = 0;
  T cfl = mom ? ld<T>(a.pre[kDtCfl], i) : T(0);

  const int c = a.cell[i];
  const int cx = c % a.nx, cy = (c / a.nx) % a.ny, cz = c / (a.nx * a.ny);
  const int rx = a.nx > 1, ry = a.ny > 1, rz = a.nz > 1;

  for (int s = 0; s < a.n_src; ++s) {
    const SrcArgs& S = a.src[s];
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
          for (int k = S.cell_start[nc]; k < kend; ++k) {
            const int j = S.order[k];
            const T xij = xi - ld<T>(S.x, j);
            const T yij = yi - ld<T>(S.y, j);
            const T zij = zi - ld<T>(S.z, j);
            const T r2 = xij * xij + yij * yij + zij * zij;
            const T hj = ld<T>(S.h, j);
            const T sup = rs * (hi > hj ? hi : hj);
            if (!(r2 < sup * sup)) continue;

            const T uij = ui - ld<T>(S.u, j);
            const T vij = vi - ld<T>(S.v, j);
            const T wij = wi - ld<T>(S.w, j);
            const T mj = ld<T>(S.m, j);
            const T hij = T(0.5) * (hi + hj);
            const T rinv = r2 > T(1e-24) ? T(1) / sqrt(r2) : T(0);
            const T rij = r2 * rinv;
            const T h1 = T(1) / (hij > T(0) ? hij : T(1));
            T wq, dwq;
            shape<T, KIND>(rij * h1, wq, dwq);
            const T fac = kfac * (a.dim == 1   ? h1
                                  : a.dim == 2 ? h1 * h1
                                               : h1 * h1 * h1);
            const T g = rij > T(1e-12) ? dwq * fac * h1 * rinv : T(0);
            const T dwx = g * xij, dwy = g * yij, dwz = g * zij;

            if (terms & kCont) arho += mj * (dwx * uij + dwy * vij + dwz * wij);
            if (terms & (kMom | kXsph)) {
              const T rhoj = ld<T>(S.rho, j);
              const T rhoij = T(0.5) * (rhoi + rhoj);
              const T rhoij1 = T(1) / (rhoij != T(0) ? rhoij : T(1));
              if (terms & kMom) {
                const T vdotx = uij * xij + vij * yij + wij * zij;
                const T cij = T(0.5) * (csi + ld<T>(S.cs, j));
                const T muij = (hij * vdotx) / (r2 + T(0.01) * hij * hij);
                T piij = (-alpha * cij * muij + beta * muij * muij) * rhoij1;
                if (!(vdotx < T(0))) piij = T(0);
                const T dtc = r2 > T(1e-12)
                                  ? fabs(hij * vdotx) * rinv * rinv + c0
                                  : T(0);
                cfl = dtc > cfl ? dtc : cfl;
                const T tmp =
                    pi * rhoi21 + ld<T>(S.p, j) * (T(1) / (rhoj * rhoj));
                const T f = -mj * (tmp + piij);
                au += f * dwx;
                av += f * dwy;
                aw += f * dwz;
              }
              if (terms & kXsph) {
                const T t = -xeps * mj * (wq * fac) * rhoij1;
                ax += t * uij;
                ay += t * vij;
                az += t * wij;
              }
            }
          }
        }
      }
    }
  }

  const bool wm = a.wmask == nullptr || a.wmask[i] != 0;
  const T acc[kNumOut] = {arho, au, av, aw, ax, ay, az, T(0)};
#pragma unroll
  for (int k = 0; k < kNumOut; ++k) {
    if (a.out[k] == nullptr) continue;
    const T pre = ld<T>(a.pre[k], i);
    T val = k == kDtCfl ? cfl : pre + acc[k];
    static_cast<T*>(a.out[k])[i] = wm ? val : pre;
  }
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
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int wcsph_pair_args_size() { return static_cast<int>(sizeof(WcsphArgs)); }

int wcsph_pair_launch(const WcsphArgs* args, void* stream) {
  const WcsphArgs a = *args;
  if (a.n_src < 0 || a.n_src > kMaxSources || a.nx < 1 || a.ny < 1 ||
      a.nz < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.dtype == 0)
    err = launch<float>(a, st);
  else if (a.dtype == 1)
    err = launch<double>(a, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* wcsph_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
