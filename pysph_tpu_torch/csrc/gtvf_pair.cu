// GTVF pair kernel for Hopper (sm_90a).
//
// Replaces pysph_tpu/ops/pallas_engine.py::_pair_kernel_compact for the
// pair phases of the GTVF dam break (examples/dam_break_2d.py --scheme
// gtvf): the two acceleration evaluators of GTVFIntegrator give five
// phase sets, one device functor each:
//
//   WallVelocity   SetWallVelocity                       -> uf vf wf wij
//   Continuity     ContinuityEquationGTVF, ContinuitySolid -> arho
//   Density        CorrectDensity                        -> rho rhodiv
//   WallPressure   VolumeSummation, SolidWallPressureBC  -> V p wij
//   Momentum       MomentumEquationPressureGradient (with the kernel
//                  gradient at h/2), MomentumEquationArtificialStress
//                                          -> au av aw auhat avhat awhat
//
// A per-source term mask (ops/gtvf_pair.py) says which equations a
// source takes.  The smoothing kernel is WendlandQuintic.  One launch
// computes every pair term of one dest array over all of its sources (at
// most 4) and writes each output once.
//
// What bounds it: per candidate pair it loads 4 to 12 source values
// through the cell-sorted index, scattered over memory, against some 30
// to 120 flops; the neighbour gather (L2 and DRAM traffic, latency), not
// arithmetic, is the limit on an H100.
//
// Design: one thread per dest particle walks the 3^dim cells around its
// own cell in each source's sorted cell list (base/cell_grid.py: no
// per-cell capacity, nothing can overflow), applies the support test
// r2 < (rs max(hi, hj))^2, computes WIJ and DWIJ with the guards of the
// torch pair engine, and hands the pair to the phase set's functor,
// which accumulates in registers.  The epilogue writes pre + sum under
// the write mask (Group real=True) and pre elsewhere.  No atomics and no
// cross-thread reduction, so the result is the same on every run.  Every
// dest read sees the value from before the phase, as in the Pallas
// kernel; the planner refuses a phase set in which one equation reads
// what another accumulates.  No fast-math: CorrectDensity divides by the
// source's rho0, which is 0 on the walls, and the reference gives IEEE
// inf there.
//
// Interface: plain C, called through ctypes (ops/gtvf_pair.py).  The
// launch function takes a host pointer to GtvfArgs (copied into the
// kernel's parameters) and the stream, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// The argument structs are at global scope: the exported C functions
// take them, and a type in an unnamed namespace would give those
// functions internal linkage.
constexpr int kMaxSources = 4;
// term bits, as ops/gtvf_pair.py
constexpr int kSwv = 1, kCgtvf = 2, kCsolid = 4, kCdens = 8, kVsum = 16,
              kWallp = 32, kMpg = 64, kMas = 128;
// outputs in the order of ops/gtvf_pair.py OUTPUTS
enum Out {
  oUf, oVf, oWf, oWij, oArho, oRho, oRhodiv, oV, oP,
  oAu, oAv, oAw, oAuhat, oAvhat, oAwhat, kNumOut
};
// phase ids: the index of the phase set in ops/gtvf_pair.py PHASE_SETS
enum Phase {
  kWallVelocity, kContinuity, kDensity, kWallPressure, kMomentum
};

struct SrcArgs {
  const void *x, *y, *z, *h, *m, *rho, *rho0, *p, *u, *v, *w, *uhat,
      *vhat, *what, *ug, *vg, *wg;
  const int32_t* order;       // particle indices sorted by cell
  const int32_t* cell_start;  // per cell: first position in order
  const int32_t* cell_end;    // per cell: one past the last
  double gx, gy, gz;          // SolidWallPressureBC's gravity
  int32_t terms, pad;
};

struct GtvfArgs {
  const void *x, *y, *z, *h, *rho, *p, *p0, *u, *v, *w, *uhat, *vhat,
      *what, *au, *av, *aw;  // dest
  const int32_t* cell;       // dest cell id, ix + nx * (iy + ny * iz)
  const uint8_t* wmask;      // write mask (bool); null: every row
  const void* pre[kNumOut];  // values before the phase; null: unused
  void* out[kNumOut];
  SrcArgs src[kMaxSources];
  double radius_scale, kfac;  // kfac: the kernel's sigma
  int32_t n_dest, n_src, nx, ny, nz, dim, phase, dtype;
};

namespace {

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

// WendlandQuintic's unnormalised shape (w, dw/dq), support q < 2
// (base/kernels.py).
template <typename T>
__device__ __forceinline__ void shape(T q, T& w, T& dw) {
  if (q < T(2)) {
    const T t = T(1) - T(0.5) * q;
    const T t3 = t * t * t;
    w = t3 * t * (T(2) * q + T(1));
    dw = T(-5) * q * t3;
  } else {
    w = T(0);
    dw = T(0);
  }
}

template <typename T>
__device__ __forceinline__ T hpow(T h1, int dim) {
  return dim == 1 ? h1 : dim == 2 ? h1 * h1 : h1 * h1 * h1;
}

// One pair in support, with the symbols the equations read.
template <typename T>
struct Pair {
  int j;
  T xij, yij, zij, rij, hij;
  T w;              // WIJ
  T dwx, dwy, dwz;  // DWIJ
};

// The output epilogue: pre + acc under the write mask, pre elsewhere.
template <typename T>
__device__ __forceinline__ void put(const GtvfArgs& a, int k, int i, T acc,
                                    bool wm) {
  if (a.out[k] == nullptr) return;
  const T pre = ld<T>(a.pre[k], i);
  static_cast<T*>(a.out[k])[i] = wm ? pre + acc : pre;
}

__device__ __forceinline__ int all_terms(const GtvfArgs& a) {
  int t = 0;
  for (int s = 0; s < a.n_src; ++s) t |= a.src[s].terms;
  return t;
}

template <typename T>
struct WallVelocity {
  T uf = 0, vf = 0, wf = 0, wij = 0;
  __device__ void load(const GtvfArgs&, int) {}
  __device__ void pair(const GtvfArgs&, const SrcArgs& S,
                       const Pair<T>& q) {
    if (!(S.terms & kSwv)) return;
    wij += q.w;
    uf += ld<T>(S.u, q.j) * q.w;
    vf += ld<T>(S.v, q.j) * q.w;
    wf += ld<T>(S.w, q.j) * q.w;
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oUf, i, uf, wm);
    put(a, oVf, i, vf, wm);
    put(a, oWf, i, wf, wm);
    put(a, oWij, i, wij, wm);
  }
};

template <typename T>
struct Continuity {
  T rhoi = 0, ui = 0, vi = 0, wi = 0, uhi = 0, vhi = 0, whi = 0;
  T arho = 0;
  __device__ void load(const GtvfArgs& a, int i) {
    const int t = all_terms(a);
    rhoi = ld<T>(a.rho, i);
    if (t & kCgtvf) {
      uhi = ld<T>(a.uhat, i);
      vhi = ld<T>(a.vhat, i);
      whi = ld<T>(a.what, i);
    }
    if (t & kCsolid) {
      ui = ld<T>(a.u, i);
      vi = ld<T>(a.v, i);
      wi = ld<T>(a.w, i);
    }
  }
  __device__ void pair(const GtvfArgs&, const SrcArgs& S,
                       const Pair<T>& q) {
    const int j = q.j;
    const T mj = ld<T>(S.m, j), rhoj = ld<T>(S.rho, j);
    if (S.terms & kCgtvf) {  // ContinuityEquationGTVF
      const T udotdij = q.dwx * (uhi - ld<T>(S.uhat, j)) +
                        q.dwy * (vhi - ld<T>(S.vhat, j)) +
                        q.dwz * (whi - ld<T>(S.what, j));
      arho += rhoi * mj / rhoj * udotdij;
    }
    if (S.terms & kCsolid) {  // ContinuitySolid
      const T Vj = mj / rhoj;
      const T vdotdw = (ui - ld<T>(S.ug, j)) * q.dwx +
                       (vi - ld<T>(S.vg, j)) * q.dwy +
                       (wi - ld<T>(S.wg, j)) * q.dwz;
      arho += rhoi * Vj * vdotdw;
    }
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oArho, i, arho, wm);
  }
};

template <typename T>
struct Density {
  T rho = 0, rhodiv = 0;
  __device__ void load(const GtvfArgs&, int) {}
  __device__ void pair(const GtvfArgs&, const SrcArgs& S,
                       const Pair<T>& q) {
    if (!(S.terms & kCdens)) return;  // CorrectDensity
    const T mw = ld<T>(S.m, q.j) * q.w;
    rho += mw;
    rhodiv += mw / ld<T>(S.rho0, q.j);  // inf where rho0 is 0
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oRho, i, rho, wm);
    put(a, oRhodiv, i, rhodiv, wm);
  }
};

template <typename T>
struct WallPressure {
  T aui = 0, avi = 0, awi = 0;
  T V = 0, p = 0, wij = 0;
  __device__ void load(const GtvfArgs& a, int i) {
    if (all_terms(a) & kWallp) {
      aui = ld<T>(a.au, i);
      avi = ld<T>(a.av, i);
      awi = ld<T>(a.aw, i);
    }
  }
  __device__ void pair(const GtvfArgs&, const SrcArgs& S,
                       const Pair<T>& q) {
    if (S.terms & kVsum) V += q.w;  // VolumeSummation
    if (S.terms & kWallp) {         // SolidWallPressureBC
      const T gdotxij = (T(S.gx) - aui) * q.xij + (T(S.gy) - avi) * q.yij +
                        (T(S.gz) - awi) * q.zij;
      p += ld<T>(S.p, q.j) * q.w + ld<T>(S.rho, q.j) * gdotxij * q.w;
      wij += q.w;
    }
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oV, i, V, wm);
    put(a, oP, i, p, wm);
    put(a, oWij, i, wij, wm);
  }
};

template <typename T>
struct Momentum {
  T rhoi = 0, rhoi2 = 0, pi = 0, p0i = 0;
  T ui[3] = {0, 0, 0}, uidif[3] = {0, 0, 0};
  T au = 0, av = 0, aw = 0, auhat = 0, avhat = 0, awhat = 0;
  __device__ void load(const GtvfArgs& a, int i) {
    const int t = all_terms(a);
    rhoi = ld<T>(a.rho, i);
    rhoi2 = rhoi * rhoi;
    if (t & kMpg) {
      pi = ld<T>(a.p, i);
      p0i = ld<T>(a.p0, i);
    }
    if (t & kMas) {
      ui[0] = ld<T>(a.u, i);
      ui[1] = ld<T>(a.v, i);
      ui[2] = ld<T>(a.w, i);
      uidif[0] = ld<T>(a.uhat, i) - ui[0];
      uidif[1] = ld<T>(a.vhat, i) - ui[1];
      uidif[2] = ld<T>(a.what, i) - ui[2];
    }
  }
  __device__ void pair(const GtvfArgs& a, const SrcArgs& S,
                       const Pair<T>& q) {
    const int j = q.j;
    const T mj = ld<T>(S.m, j), rhoj = ld<T>(S.rho, j);
    if (S.terms & kMpg) {  // MomentumEquationPressureGradient
      const T pij = pi / rhoi2 + ld<T>(S.p, j) / (rhoj * rhoj);
      const T tmp = -mj * pij;
      au += tmp * q.dwx;
      av += tmp * q.dwy;
      aw += tmp * q.dwz;
      // SPH_KERNEL.gradient(XIJ, RIJ, 0.5 * HIJ)
      const T h = T(0.5) * q.hij;
      const T h1 = T(1) / h;
      T wq, dwq;
      shape<T>(q.rij * h1, wq, dwq);
      const T wdash = dwq * (T(a.kfac) * hpow(h1, a.dim));
      const T g = q.rij > T(1e-12) ? wdash / (h * q.rij) : T(0);
      const T tmph = -p0i * mj / rhoi2;
      auhat += tmph * (g * q.xij);
      avhat += tmph * (g * q.yij);
      awhat += tmph * (g * q.zij);
    }
    if (S.terms & kMas) {  // MomentumEquationArtificialStress
      const T uj[3] = {ld<T>(S.u, j), ld<T>(S.v, j), ld<T>(S.w, j)};
      const T ujdif[3] = {ld<T>(S.uhat, j) - uj[0], ld<T>(S.vhat, j) - uj[1],
                          ld<T>(S.what, j) - uj[2]};
      const T dw[3] = {q.dwx, q.dwy, q.dwz};
      T res[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T acc = T(0);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          acc += (ui[c] * uidif[d] / rhoi + uj[c] * ujdif[d] / rhoj) * dw[d];
        res[c] = acc;
      }
      au += mj * res[0];
      av += mj * res[1];
      aw += mj * res[2];
    }
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oAu, i, au, wm);
    put(a, oAv, i, av, wm);
    put(a, oAw, i, aw, wm);
    put(a, oAuhat, i, auhat, wm);
    put(a, oAvhat, i, avhat, wm);
    put(a, oAwhat, i, awhat, wm);
  }
};

// The cell walk shared by every phase set.
template <typename T, class PhaseSet>
__global__ void __launch_bounds__(128) gtvf_pair_kernel(const GtvfArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_dest) return;

  const T xi = ld<T>(a.x, i), yi = ld<T>(a.y, i), zi = ld<T>(a.z, i);
  const T hi = ld<T>(a.h, i);
  const T rs = T(a.radius_scale), kfac = T(a.kfac);
  PhaseSet ph;
  ph.load(a, i);

  const int c = a.cell[i];
  const int cx = c % a.nx, cy = (c / a.nx) % a.ny, cz = c / (a.nx * a.ny);
  const int rx = a.nx > 1, ry = a.ny > 1, rz = a.nz > 1;

  for (int s = 0; s < a.n_src; ++s) {
    const SrcArgs& S = a.src[s];
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
            Pair<T> q;
            q.j = S.order[k];
            q.xij = xi - ld<T>(S.x, q.j);
            q.yij = yi - ld<T>(S.y, q.j);
            q.zij = zi - ld<T>(S.z, q.j);
            const T r2 = q.xij * q.xij + q.yij * q.yij + q.zij * q.zij;
            const T hj = ld<T>(S.h, q.j);
            const T sup = rs * (hi > hj ? hi : hj);
            if (!(r2 < sup * sup)) continue;

            q.hij = T(0.5) * (hi + hj);
            const T rinv = r2 > T(1e-24) ? T(1) / sqrt(r2) : T(0);
            q.rij = r2 * rinv;
            const T h1 = T(1) / (q.hij > T(0) ? q.hij : T(1));
            T wq, dwq;
            shape<T>(q.rij * h1, wq, dwq);
            const T fac = kfac * hpow(h1, a.dim);
            q.w = wq * fac;
            const T g = q.rij > T(1e-12) ? dwq * fac * h1 * rinv : T(0);
            q.dwx = g * q.xij;
            q.dwy = g * q.yij;
            q.dwz = g * q.zij;
            ph.pair(a, S, q);
          }
        }
      }
    }
  }

  ph.store(a, i, a.wmask == nullptr || a.wmask[i] != 0);
}

template <typename T>
cudaError_t launch(const GtvfArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.n_dest + threads - 1) / threads;
  switch (a.phase) {
    case kWallVelocity:
      gtvf_pair_kernel<T, WallVelocity<T>><<<blocks, threads, 0, stream>>>(a);
      break;
    case kContinuity:
      gtvf_pair_kernel<T, Continuity<T>><<<blocks, threads, 0, stream>>>(a);
      break;
    case kDensity:
      gtvf_pair_kernel<T, Density<T>><<<blocks, threads, 0, stream>>>(a);
      break;
    case kWallPressure:
      gtvf_pair_kernel<T, WallPressure<T>><<<blocks, threads, 0, stream>>>(a);
      break;
    case kMomentum:
      gtvf_pair_kernel<T, Momentum<T>><<<blocks, threads, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int gtvf_pair_args_size() { return static_cast<int>(sizeof(GtvfArgs)); }

int gtvf_pair_launch(const GtvfArgs* args, void* stream) {
  const GtvfArgs a = *args;
  if (a.n_src < 0 || a.n_src > kMaxSources || a.nx < 1 || a.ny < 1 ||
      a.nz < 1 || a.dim < 1 || a.dim > 3)
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

const char* gtvf_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
