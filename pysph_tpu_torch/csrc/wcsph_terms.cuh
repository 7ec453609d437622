// The WCSPH pair terms shared by csrc/wcsph_pair.cu, csrc/dense_pair.cu
// and csrc/pair_stub.cu.
//
// The two pair kernels compute the same contract (ops/wcsph_pair.py): the
// ContinuityEquation, the MomentumEquation (artificial viscosity and the
// dt_cfl max, with or without the tensile correction), XSPHCorrection,
// LaminarViscosity, SummationDensity and, in wcsph_pair only, the three
// delta-SPH terms (ContinuityEquationDeltaSPH, MomentumEquationDeltaSPH,
// LaminarViscosityDeltaSPH) of one dest array over at most kMaxSources
// sources, each output written once as pre + sum (max(pre, m) for
// dt_cfl) under the write mask, on an open or a periodic grid.
//
// The terms the dam breaks' main path does not take (kLvisc, kTens,
// kSumRho, kLvd) are compiled only into the kernels built with the
// template flag EXTRA, so that those without it are the code they were.  They
// differ only in how a dest reaches its source particles
// (csrc/cell_walk.cuh), so everything else lives here: the argument
// struct, the packed source records and the per-pair body (the shape
// functions are csrc/shapes.cuh's).  The body reads a source through a
// functor (`Src::x(j)`, ...); the walks hand it one candidate's records
// (Cand).  On a periodic grid (the kernels' template flag PERIODIC) every
// displacement, in the walk's support test and in the body, is the
// minimum image d - L rint(d / L) with the box lengths of the arguments.
//
// Sources are read from their packed copy (csrc/cell_pack.cuh), whose
// record planes are, as ops/wcsph_pair.py PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: u v w m
//   plane 2: rho p cs 0
//   plane 3: gradrho[0] gradrho[1] gradrho[2] 0
// the third only where the term mask reads rho (p and cs 0 where it reads
// neither: kLvisc and kLvd read rho alone), the fourth only where it holds
// kDcont; kSumRho reads the first two.  The dest's gradrho,
// an (n, 3) array, is read from its row.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "shapes.cuh"

// The argument structs are at global scope: the exported C functions
// take them, and a type in an unnamed namespace would give those
// functions internal linkage.
constexpr int kMaxSources = 4;
constexpr int kCont = 1, kMom = 2, kXsph = 4, kDcont = 8, kDmom = 16,
              kLvisc = 32, kTens = 64, kSumRho = 128, kLvd = 256;
// the terms of the kernels built with EXTRA
constexpr int kExtra = kLvisc | kTens | kSumRho | kLvd;
// outputs in the order of ops/wcsph_pair.py OUTPUTS: arho, au, av, aw,
// ax, ay, az, dt_cfl, rho (the last only in the kernels built with EXTRA)
constexpr int kDtCfl = 7, kRho = 8, kNumOut = 9;

struct SrcArgs {
  // the packed copy: record k holds particle order[k], the source's
  // particles in cell order (ops/wcsph_pair.py pack_sources)
  const void* pos;     // {x, y, z, h}
  const void* vel;     // {u, v, w, m}
  const void* thermo;  // {rho, p, cs, 0}; null where the terms read no rho
  const void* grad;    // {gradrho, 0}; null without kDcont
  const int32_t* cell_start;  // per cell: first position in the copy
  const int32_t* cell_end;    // per cell: one past the last
  double c0, alpha, beta, xsph_eps;
  // kDcont: delta, its c0; kDmom: alpha, c0, rho0; kLvisc: nu, eta; kLvd:
  // 2 (dim + 2) nu rho0
  double delta, delta_c0, dmom_alpha, dmom_c0, rho0, nu, eta, lvd_fac;
  int32_t terms, pad;
};

struct WcsphArgs {
  const void *x, *y, *z, *u, *v, *w, *h, *rho, *p, *cs;  // dest
  const void* gradrho;  // dest, (n, 3); read with kDcont
  const int32_t* cell;   // dest cell id, ix + nx * (iy + ny * iz)
  // the dest's own cell list: threads follow its order
  const int32_t *dorder, *dcell_start, *dcell_end;
  const uint8_t* wmask;  // write mask (bool); null: every row
  const void* pre[kNumOut];  // values before the phase; null: unused
  void* out[kNumOut];
  SrcArgs src[kMaxSources];
  // kfac: the kernel's sigma; wdp: w(deltap), unnormalised (kTens)
  double radius_scale, kfac, wdp;
  double box[3];  // the length of each periodic axis, 0 on the others
  int32_t n_dest, n_src, nx, ny, nz, dim, kernel_kind, dtype, periodic;
  // the pack that fills the sources' pos, vel and thermo: the launch
  // functions launch it just before the walk (n_src 0: none)
  PackArgs pack;
};

namespace wcsph {

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

// The shape functions, by kernel_kind (csrc/shapes.cuh).
using shapes::shape;

using walk::Rec;
using walk::rec;

// One candidate's packed records, as the pair body reads them (the
// body's particle index is not used: the values are already here).
template <typename T>
struct Cand {
  Rec<T> pos, vel, th, gr;
  __device__ T x(int) const { return pos.a; }
  __device__ T y(int) const { return pos.b; }
  __device__ T z(int) const { return pos.c; }
  __device__ T h(int) const { return pos.d; }
  __device__ T u(int) const { return vel.a; }
  __device__ T v(int) const { return vel.b; }
  __device__ T w(int) const { return vel.c; }
  __device__ T m(int) const { return vel.d; }
  __device__ T rho(int) const { return th.a; }
  __device__ T p(int) const { return th.b; }
  __device__ T cs(int) const { return th.c; }
  __device__ T gx(int) const { return gr.a; }
  __device__ T gy(int) const { return gr.b; }
  __device__ T gz(int) const { return gr.c; }
};

// The delta-SPH terms' constants of one source, in the working type.
template <typename T>
struct DeltaConsts {
  T delta, delta_c0, dmom_alpha, dmom_c0, rho0;
};

template <typename T>
__device__ __forceinline__ DeltaConsts<T> delta_consts(const SrcArgs& S) {
  return {T(S.delta), T(S.delta_c0), T(S.dmom_alpha), T(S.dmom_c0),
          T(S.rho0)};
}

// The constants of one source's EXTRA terms, in the working type:
// LaminarViscosity's, LaminarViscosityDeltaSPH's and the tensile
// correction's w(deltap).
template <typename T>
struct ExtraConsts {
  T nu, eta, lvd_fac, wdp;
};

template <typename T>
__device__ __forceinline__ ExtraConsts<T> extra_consts(const WcsphArgs& a,
                                                       const SrcArgs& S) {
  return {T(S.nu), T(S.eta), T(S.lvd_fac), T(a.wdp)};
}

// The box of the arguments' periodic axes (walk::Box), in the working
// type.
template <typename T>
__device__ __forceinline__ walk::Box<T> box_of(const WcsphArgs& a) {
  return {{T(a.box[0]), T(a.box[1]), T(a.box[2])}};
}

// One dest particle: its values, read once, and its accumulators.
template <typename T>
struct Dest {
  T xi, yi, zi, ui, vi, wi, hi, rhoi, pi, csi, rhoi21, gxi, gyi, gzi;
  T arho, au, av, aw, ax, ay, az, cfl, rho;

  // dterms: the union of the sources' term masks; DELTA, EXTRA: whether
  // they may hold the delta-SPH terms, the kExtra terms (a kernel without
  // them is built apart, so that their registers cost the other paths
  // nothing)
  template <bool DELTA = false, bool EXTRA = false>
  __device__ void load(const WcsphArgs& a, int i, int dterms) {
    const bool need_rho =
        dterms & (kMom | kXsph | (DELTA ? kDcont | kDmom : 0) |
                  (EXTRA ? kLvisc | kLvd : 0));
    const bool dcont = DELTA && (dterms & kDcont);
    const bool mom = dterms & kMom;
    xi = ld<T>(a.x, i);
    yi = ld<T>(a.y, i);
    zi = ld<T>(a.z, i);
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    hi = ld<T>(a.h, i);
    rhoi = need_rho ? ld<T>(a.rho, i) : T(0);
    pi = mom ? ld<T>(a.p, i) : T(0);
    csi = mom ? ld<T>(a.cs, i) : T(0);
    rhoi21 = mom ? T(1) / (rhoi * rhoi) : T(0);
    gxi = dcont ? ld<T>(a.gradrho, 3 * i) : T(0);
    gyi = dcont ? ld<T>(a.gradrho, 3 * i + 1) : T(0);
    gzi = dcont ? ld<T>(a.gradrho, 3 * i + 2) : T(0);
    arho = au = av = aw = ax = ay = az = rho = T(0);
    cfl = mom ? ld<T>(a.pre[kDtCfl], i) : T(0);
  }

  // The pair (this dest, source particle j), with the support test
  // r2 < (rs max(hi, hj))^2 and the guards of the torch pair engine.
  // dc: the delta-SPH terms' constants (read only with kDcont, kDmom,
  // in a kernel built with DELTA); ec: the kExtra terms' (a kernel built
  // with EXTRA); box: the periodic axes' lengths (a kernel built with
  // PERIODIC, which takes the minimum image of each displacement).
  template <int KIND, bool DELTA = false, bool EXTRA = false,
            bool PERIODIC = false, class Src>
  __device__ __forceinline__ void pair(const Src& s, int j, int terms,
                                       T c0, T alpha, T beta, T xeps, T rs,
                                       T kfac, int dim,
                                       const DeltaConsts<T>& dc = {},
                                       const ExtraConsts<T>& ec = {},
                                       const walk::Box<T>& box = {}) {
    T xij = xi - s.x(j);
    T yij = yi - s.y(j);
    T zij = zi - s.z(j);
    if (PERIODIC) {
      xij = walk::image(xij, box.len[0]);
      yij = walk::image(yij, box.len[1]);
      zij = walk::image(zij, box.len[2]);
    }
    const T r2 = xij * xij + yij * yij + zij * zij;
    const T hj = s.h(j);
    const T sup = rs * (hi > hj ? hi : hj);
    if (!(r2 < sup * sup)) return;

    const T uij = ui - s.u(j);
    const T vij = vi - s.v(j);
    const T wij = wi - s.w(j);
    const T mj = s.m(j);
    const T hij = T(0.5) * (hi + hj);
    const T rinv = r2 > T(1e-24) ? T(1) / sqrt(r2) : T(0);
    const T rij = r2 * rinv;
    const T h1 = T(1) / (hij > T(0) ? hij : T(1));
    T wq, dwq;
    shape<T, KIND>(rij * h1, wq, dwq);
    const T fac = kfac * (dim == 1   ? h1
                          : dim == 2 ? h1 * h1
                                     : h1 * h1 * h1);
    const T g = rij > T(1e-12) ? dwq * fac * h1 * rinv : T(0);
    const T dwx = g * xij, dwy = g * yij, dwz = g * zij;

    if (terms & kCont) arho += mj * (dwx * uij + dwy * vij + dwz * wij);
    // SummationDensity
    if (EXTRA && (terms & kSumRho)) rho += mj * (wq * fac);
    if (DELTA && (terms & (kDcont | kDmom))) {
      const T rhoj = s.rho(j);
      const T vj = mj / rhoj;
      const T eps = T(0.01) * hij * hij;
      if (terms & kDcont) {
        const T fac = T(-2) * (rhoj - rhoi) / (r2 + eps);
        const T psix = fac * xij - gxi - s.gx(j);
        const T psiy = fac * yij - gyi - s.gy(j);
        const T psiz = fac * zij - gzi - s.gz(j);
        const T psidot = psix * dwx + psiy * dwy + psiz * dwz;
        arho += dc.delta * hij * dc.delta_c0 * psidot * vj;
      }
      if (terms & kDmom) {
        const T vdotx = uij * xij + vij * yij + wij * zij;
        const T fac = dc.dmom_alpha * hij * dc.dmom_c0 * dc.rho0;
        const T t = fac * (vdotx / (r2 + eps)) * vj / rhoi;
        au += t * dwx;
        av += t * dwy;
        aw += t * dwz;
      }
    }
    if (EXTRA && (terms & kLvd)) {  // LaminarViscosityDeltaSPH
      const T vj = mj / s.rho(j);
      const T vdotx = uij * xij + vij * yij + wij * zij;
      const T piij = vdotx / (r2 + T(0.01) * hij * hij);
      const T t = ec.lvd_fac * piij * vj / rhoi;
      au += t * dwx;
      av += t * dwy;
      aw += t * dwz;
    }
    if (terms & (kMom | kXsph | (EXTRA ? kLvisc : 0))) {
      const T rhoj = s.rho(j);
      const T rhoij = T(0.5) * (rhoi + rhoj);
      const T rhoij1 = T(1) / (rhoij != T(0) ? rhoij : T(1));
      if (terms & kMom) {
        const T vdotx = uij * xij + vij * yij + wij * zij;
        const T cij = T(0.5) * (csi + s.cs(j));
        const T muij = (hij * vdotx) / (r2 + T(0.01) * hij * hij);
        T piij = (-alpha * cij * muij + beta * muij * muij) * rhoij1;
        if (!(vdotx < T(0))) piij = T(0);
        const T dtc =
            r2 > T(1e-12) ? fabs(hij * vdotx) * rinv * rinv + c0 : T(0);
        cfl = dtc > cfl ? dtc : cfl;
        const T pj = s.p(j);
        const T tmpj = pj * (T(1) / (rhoj * rhoj));
        T tmp = pi * rhoi21 + tmpj;
        if (EXTRA && (terms & kTens)) {  // the tensile correction
          const T tmpi = pi * rhoi21;
          T fij = wq / ec.wdp;
          fij = fij * fij;
          fij = fij * fij;
          const T ri = pi > T(0) ? T(0.01) * tmpi : T(0.2) * fabs(tmpi);
          const T rj = pj > T(0) ? T(0.01) * tmpj : T(0.2) * fabs(tmpj);
          tmp = tmp + (ri + rj) * fij;
        }
        const T f = -mj * (tmp + piij);
        au += f * dwx;
        av += f * dwy;
        aw += f * dwz;
      }
      if (EXTRA && (terms & kLvisc)) {  // LaminarViscosity
        const T fij = dwx * xij + dwy * yij + dwz * zij;
        const T t = mj * T(4) * ec.nu * fij /
                    ((rhoi + rhoj) * (r2 + ec.eta * hij * hij));
        au += t * uij;
        av += t * vij;
        aw += t * wij;
      }
      if (terms & kXsph) {
        const T t = -xeps * mj * (wq * fac) * rhoij1;
        ax += t * uij;
        ay += t * vij;
        az += t * wij;
      }
    }
  }

  // {xi, yi, zi, hi}: the walk's support test
  __device__ Rec<T> point() const { return {xi, yi, zi, hi}; }

  // pre + sum (max(pre, m) for dt_cfl) where the write mask is set,
  // pre elsewhere; rho only in a kernel built with EXTRA.
  template <bool EXTRA = false>
  __device__ void store(const WcsphArgs& a, int i) const {
    const bool wm = a.wmask == nullptr || a.wmask[i] != 0;
    const T acc[kNumOut] = {arho, au, av, aw, ax, ay, az, T(0), rho};
#pragma unroll
    for (int k = 0; k < (EXTRA ? kNumOut : kRho); ++k) {
      if (a.out[k] == nullptr) continue;
      const T pre = ld<T>(a.pre[k], i);
      const T val = k == kDtCfl ? cfl : pre + acc[k];
      static_cast<T*>(a.out[k])[i] = wm ? val : pre;
    }
  }
};

// The walk over one source for a lane (walk::walk_rows), with the grid
// and the source's cell ranges and {x, y, z, h} plane of `a`; PERIODIC:
// walk::walk_rows_periodic with the box of `a` (halo 1).
template <bool PERIODIC = false, typename T, class Body>
__device__ __forceinline__ void walk_rows(const WcsphArgs& a,
                                          const SrcArgs& S,
                                          const walk::Lane& l, int halo,
                                          const Dest<T>& d, T rs,
                                          walk::Walker<T>& walker,
                                          Body& body) {
  if (PERIODIC)
    walk::walk_rows_periodic(a, S.cell_start, S.cell_end, S.pos, l,
                             d.point(), rs, box_of<T>(a), walker, body);
  else
    walk::walk_rows(a, S.cell_start, S.cell_end, S.pos, l, halo,
                    d.point(), rs, walker, body);
}

// The union of the sources' term masks.
__device__ __forceinline__ int dest_terms(const WcsphArgs& a) {
  int t = 0;
  for (int s = 0; s < a.n_src; ++s) t |= a.src[s].terms;
  return t;
}

// Checks shared by the launch functions.
inline bool args_ok(const WcsphArgs& a) {
  return a.n_src >= 0 && a.n_src <= kMaxSources && a.nx >= 1 && a.ny >= 1 &&
         a.nz >= 1 && a.kernel_kind >= 0 && a.kernel_kind < shapes::kKinds &&
         (a.dtype == 0 || a.dtype == 1) && pack::args_ok(a.pack) &&
         (a.pack.n_src == 0 || a.pack.dtype == a.dtype);
}

}  // namespace wcsph
