// IISPH's pair terms for Hopper (sm_90a), shared by csrc/iisph_pair.cu
// (every pair phase of IISPHScheme, one launch a phase) and
// csrc/iisph_solve.cu (the iterated pressure group, every sweep in one
// launch): the source records, the pair symbols (pair_of), the six phase
// sets' functors and the pair loop of one dest (sum_pairs), so that both
// kernels take the same pairs in the same order and sum them with the same
// code, bit for bit.
//
// A functor: kTerms, the term bits of its set; kEmits, whether its walk may
// write the neighbour list; load(a, i), the dest's values from the launch's
// args; pair(S, q), one pair in support of the source S; store(a, i, wm),
// the epilogue.  Dijpj and Solve take LIVE: their source planes kDiiP and
// kDijpjP (piter, dijpj) are then read through L2 (rec_live), as
// iisph_solve writes them between grid barriers; the other planes, and
// every plane of iisph_pair, are read-only for a launch's lifetime and go
// through the read-only cache (walk::rec).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_walk.cuh"
#include "shapes.cuh"

constexpr int kIisphSources = 4;
// term bits, as ops/iisph_pair.py
constexpr int kNden = 1, kSden = 2, kSdenB = 4, kDii = 8, kDiiB = 16,
              kVisc = 32, kViscB = 64, kRhoAdv = 128, kRhoB = 256,
              kAii = 512, kAiiB = 1024, kDijpj = 2048, kSolve = 4096,
              kSolveB = 8192, kForce = 16384, kForceB = 32768;
// outputs in the order of ops/iisph_pair.py OUTPUTS
enum IisphOut {
  oV, oRho, oDii0, oDii1, oDii2, oAu, oAv, oAw, oRhoAdv, oAii, oDijpj0,
  oDijpj1, oDijpj2, oP, kIisphOut
};
// phase ids: the index of the phase set in ops/iisph_pair.py PHASE_SETS
enum IisphPhase { kDensity, kAdvection, kRhoAdvection, kDijpjSet, kSolveSet,
                  kForceSet };
// the record planes of a packed copy (csrc/iisph_pair.cu)
enum IisphPlane { kPos, kMass, kVel, kAdv, kDiiP, kDijpjP, kIisphPlanes };
// the modes, as ops/iisph_pair.py WALK, EMIT, CONSUME
constexpr int kWalk = 0, kEmit = 1, kConsume = 2;
// kConsume: listed entries whose loads a lane has in flight
constexpr int kListBatch = 4;

struct IisphSrc {
  // the packed copy's planes, in the source's cell order; null where the
  // source's terms read none of the plane's props (kConsume: plane 0 is
  // the emitting launch's copy)
  const void* plane[kIisphPlanes];
  const int32_t* cell_start;  // per cell: first position in the copy
  const int32_t* cell_end;    // per cell: one past the last
  double rho0;                // the wall terms' rest density
  double nu;                  // the viscosities' nu
  int32_t terms;  // 0 (or none of a set's): a copy of the emitter skipped
  int32_t base;   // its position 0 in the neighbour list's numbering
};

namespace iisph {

using walk::Rec;
using walk::rec;

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

// Record k of a plane that a launch writes between grid barriers: one
// 16-byte load in float, two in double, through L2 (ld.global.cg), which
// another SM's stores before the barrier have reached.
__device__ __forceinline__ Rec<float> rec_live(const float* p, int k) {
  const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + k);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Rec<double> rec_live(const double* p, int k) {
  const double2* q = reinterpret_cast<const double2*>(p) + 2 * k;
  const double2 lo = __ldcg(q), hi = __ldcg(q + 1);
  return {lo.x, lo.y, hi.x, hi.y};
}
template <typename T, bool LIVE>
__device__ __forceinline__ Rec<T> rec_of(const void* p, int k) {
  if (LIVE) return rec_live(static_cast<const T*>(p), k);
  return rec<T>(p, k);
}

template <typename T>
__device__ __forceinline__ T hpow(T h1, int dim) {
  return dim == 1 ? h1 : dim == 2 ? h1 * h1 : h1 * h1 * h1;
}

// One pair in support, with the symbols the equations read: k is the
// source particle's position in its packed copy.
template <typename T>
struct Pair {
  int k;
  T xij, yij, zij, r2, hij;
  T w;              // WIJ
  T dwx, dwy, dwz;  // DWIJ
};

// The pair of the dest di ({xi, yi, zi, hi}) and the source particle at
// position k whose {x, y, z, h} record is pj, as csrc/tvf_pair.cu's: the
// minimum image on a periodic grid, r2, hij, WIJ and DWIJ.  Every mode of
// both kernels computes its pairs here, so that their sums agree bit for
// bit.
template <typename T, int KIND, bool PERIODIC>
__device__ __forceinline__ Pair<T> pair_of(const Rec<T>& di,
                                           const Rec<T>& pj, int k,
                                           const walk::Box<T>& box, T kfac,
                                           int dim) {
  Pair<T> q;
  q.k = k;
  q.xij = di.a - pj.a;
  q.yij = di.b - pj.b;
  q.zij = di.c - pj.c;
  if (PERIODIC) {
    q.xij = walk::image(q.xij, box.len[0]);
    q.yij = walk::image(q.yij, box.len[1]);
    q.zij = walk::image(q.zij, box.len[2]);
  }
  q.r2 = q.xij * q.xij + q.yij * q.yij + q.zij * q.zij;
  q.hij = T(0.5) * (di.d + pj.d);
  const T rinv = q.r2 > T(1e-24) ? T(1) / sqrt(q.r2) : T(0);
  const T rij = q.r2 * rinv;
  const T h1 = T(1) / (q.hij > T(0) ? q.hij : T(1));
  T wq, dwq;
  shapes::shape<T, KIND>(rij * h1, wq, dwq);
  const T fac = kfac * hpow(h1, dim);
  q.w = wq * fac;
  const T gr = rij > T(1e-12) ? dwq * fac * h1 * rinv : T(0);
  q.dwx = gr * q.xij;
  q.dwy = gr * q.yij;
  q.dwz = gr * q.zij;
  return q;
}

// The output epilogue: pre + acc under the write mask, pre elsewhere.
template <typename T, class A>
__device__ __forceinline__ void put(const A& a, int k, int i, T acc,
                                    bool wm) {
  if (a.out[k] == nullptr) return;
  const T pre = ld<T>(a.pre[k], i);
  static_cast<T*>(a.out[k])[i] = wm ? pre + acc : pre;
}

template <class A>
__host__ __device__ __forceinline__ int all_terms(const A& a) {
  int t = 0;
  for (int s = 0; s < a.n_src; ++s) t |= a.src[s].terms;
  return t;
}

// NumberDensity, SummationDensity, SummationDensityBoundary.
template <typename T>
struct Density {
  static constexpr int kTerms = kNden | kSden | kSdenB;
  static constexpr bool kEmits = true;
  T V = 0, rho = 0;
  template <class A>
  __device__ void load(const A&, int) {}
  __device__ void pair(const IisphSrc& S, const Pair<T>& q) {
    if (S.terms & kNden) V += q.w;
    if (S.terms & (kSden | kSdenB)) {
      const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho V p
      if (S.terms & kSden) rho += mass.a * q.w;
      if (S.terms & kSdenB) rho += T(S.rho0) / mass.c * q.w;
    }
  }
  template <class A>
  __device__ void store(const A& a, int i, bool wm) {
    put(a, oV, i, V, wm);
    put(a, oRho, i, rho, wm);
  }
};

// ComputeDII, ComputeDIIBoundary, ViscosityAcceleration(+Boundary).
template <typename T>
struct Advection {
  static constexpr int kTerms = kDii | kDiiB | kVisc | kViscB;
  static constexpr bool kEmits = true;
  T rhoi = 0, rho_1 = 0;
  T ui[3] = {};
  T dii0 = 0, dii1 = 0, dii2 = 0, au = 0, av = 0, aw = 0;
  template <class A>
  __device__ void load(const A& a, int i) {
    rhoi = ld<T>(a.rho, i);
    rho_1 = T(1) / rhoi;
    if (all_terms(a) & (kVisc | kViscB)) {
      ui[0] = ld<T>(a.u, i);
      ui[1] = ld<T>(a.v, i);
      ui[2] = ld<T>(a.w, i);
    }
  }
  __device__ void pair(const IisphSrc& S, const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho V p
    if (S.terms & kDii) {  // ComputeDII
      const T fac = -mass.a * rho_1 * rho_1;
      dii0 += fac * q.dwx;
      dii1 += fac * q.dwy;
      dii2 += fac * q.dwz;
    }
    if (S.terms & kDiiB) {  // ComputeDIIBoundary
      const T fac = -rho_1 * rho_1 * T(S.rho0) / mass.c;
      dii0 += fac * q.dwx;
      dii1 += fac * q.dwy;
      dii2 += fac * q.dwz;
    }
    if (S.terms & (kVisc | kViscB)) {
      const Rec<T> vel = rec<T>(S.plane[kVel], q.k);
      const T vij[3] = {ui[0] - vel.a, ui[1] - vel.b, ui[2] - vel.c};
      const T eps = T(0.01) * q.hij * q.hij;
      const T dot = q.dwx * q.xij + q.dwy * q.yij + q.dwz * q.zij;
      T fac;
      if (S.terms & kVisc) {  // ViscosityAcceleration
        const T rhoij = T(0.5) * (rhoi + mass.b);
        const T rhoij1 = T(1) / (rhoij != T(0) ? rhoij : T(1));
        fac = T(2) * T(S.nu) * mass.a * rhoij1 * dot / (q.r2 + eps);
      } else {  // ViscosityAccelerationBoundary
        const T phi_b = T(S.rho0) / (mass.c * rhoi);
        fac = T(2) * T(S.nu) * phi_b * dot / (q.r2 + eps);
      }
      au += fac * vij[0];
      av += fac * vij[1];
      aw += fac * vij[2];
    }
  }
  template <class A>
  __device__ void store(const A& a, int i, bool wm) {
    put(a, oDii0, i, dii0, wm);
    put(a, oDii1, i, dii1, wm);
    put(a, oDii2, i, dii2, wm);
    put(a, oAu, i, au, wm);
    put(a, oAv, i, av, wm);
    put(a, oAw, i, aw, wm);
  }
};

// ComputeRhoAdvection, ComputeRhoBoundary, ComputeAII,
// ComputeAIIBoundary.  The step's dt: the device value where the launch
// takes one (a.dt_at, the chunk's), else a.dt.
template <typename T>
struct RhoAdv {
  static constexpr int kTerms = kRhoAdv | kRhoB | kAii | kAiiB;
  static constexpr bool kEmits = false;
  T adv[3] = {}, dii[3] = {};
  T fac = 0, dt = 0;  // fac = m_i / rho_i^2
  T rho_adv = 0, aii = 0;
  template <class A>
  __device__ void load(const A& a, int i) {
    const int t = all_terms(a);
    dt = T(a.dt_at != nullptr ? *a.dt_at : a.dt);
    if (t & (kRhoAdv | kRhoB)) {
      adv[0] = ld<T>(a.uadv, i);
      adv[1] = ld<T>(a.vadv, i);
      adv[2] = ld<T>(a.wadv, i);
    }
    if (t & (kAii | kAiiB)) {
      const T rho1 = T(1) / ld<T>(a.rho, i);
      fac = ld<T>(a.m, i) * rho1 * rho1;
      dii[0] = ld<T>(a.dii0, i);
      dii[1] = ld<T>(a.dii1, i);
      dii[2] = ld<T>(a.dii2, i);
    }
  }
  __device__ void pair(const IisphSrc& S, const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho V p
    if (S.terms & (kRhoAdv | kRhoB)) {
      // the source's advected velocity, or a wall's velocity
      const Rec<T> vj = rec<T>(S.plane[(S.terms & kRhoAdv) ? kAdv : kVel],
                               q.k);
      const T dot = (adv[0] - vj.a) * q.dwx + (adv[1] - vj.b) * q.dwy +
                    (adv[2] - vj.c) * q.dwz;
      if (S.terms & kRhoAdv)  // ComputeRhoAdvection
        rho_adv += dt * mass.a * dot;
      else  // ComputeRhoBoundary
        rho_adv += dt * (T(S.rho0) / mass.c) * dot;
    }
    if (S.terms & (kAii | kAiiB)) {
      const T dot = (dii[0] - fac * q.dwx) * q.dwx +
                    (dii[1] - fac * q.dwy) * q.dwy +
                    (dii[2] - fac * q.dwz) * q.dwz;
      if (S.terms & kAii)  // ComputeAII
        aii += mass.a * dot;
      else  // ComputeAIIBoundary
        aii += (T(S.rho0) / mass.c) * dot;
    }
  }
  template <class A>
  __device__ void store(const A& a, int i, bool wm) {
    put(a, oRhoAdv, i, rho_adv, wm);
    put(a, oAii, i, aii, wm);
  }
};

// ComputeDIJPJ: the source's -m_j piter_j / rho_j^2 DWIJ.
template <typename T, bool LIVE = false>
struct Dijpj {
  static constexpr int kTerms = kDijpj;
  static constexpr bool kEmits = false;
  T d0 = 0, d1 = 0, d2 = 0;
  template <class A>
  __device__ void load(const A&, int) {}
  __device__ void pair(const IisphSrc& S, const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho V p
    const T piter = rec_of<T, LIVE>(S.plane[kDiiP], q.k).d;
    const T rho1 = T(1) / mass.b;
    const T fac = -mass.a * rho1 * rho1 * piter;
    d0 += fac * q.dwx;
    d1 += fac * q.dwy;
    d2 += fac * q.dwz;
  }
  template <class A>
  __device__ void store(const A& a, int i, bool wm) {
    put(a, oDijpj0, i, d0, wm);
    put(a, oDijpj1, i, d1, wm);
    put(a, oDijpj2, i, d2, wm);
  }
};

// PressureSolve, PressureSolveBoundary: one relaxed-Jacobi sweep's sum.
template <typename T, bool LIVE = false>
struct Solve {
  static constexpr int kTerms = kSolve | kSolveB;
  static constexpr bool kEmits = false;
  T fac = 0;  // m_i piter_i / rho_i^2
  T dijpj[3] = {};
  T p = 0;
  // the dest's own factors: with the PressureSolve term (solve), fac
  __device__ void own(T m, T rho, T piter, T d0, T d1, T d2, bool solve) {
    const T rho1 = T(1) / rho;
    if (solve) fac = m * rho1 * rho1 * piter;
    dijpj[0] = d0;
    dijpj[1] = d1;
    dijpj[2] = d2;
  }
  template <class A>
  __device__ void load(const A& a, int i) {
    const bool solve = all_terms(a) & kSolve;
    own(solve ? ld<T>(a.m, i) : T(0), ld<T>(a.rho, i),
        solve ? ld<T>(a.piter, i) : T(0), ld<T>(a.dijpj0, i),
        ld<T>(a.dijpj1, i), ld<T>(a.dijpj2, i), solve);
  }
  __device__ void pair(const IisphSrc& S, const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho V p
    if (S.terms & kSolve) {  // PressureSolve
      const Rec<T> dj = rec_of<T, LIVE>(S.plane[kDiiP], q.k);    // dii piter
      const Rec<T> pj = rec_of<T, LIVE>(S.plane[kDijpjP], q.k);  // dijpj
      const T djkpk0 = pj.a - fac * q.dwx;
      const T djkpk1 = pj.b - fac * q.dwy;
      const T djkpk2 = pj.c - fac * q.dwz;
      const T tmp0 = dijpj[0] - dj.a * dj.d - djkpk0;
      const T tmp1 = dijpj[1] - dj.b * dj.d - djkpk1;
      const T tmp2 = dijpj[2] - dj.c * dj.d - djkpk2;
      const T dot = tmp0 * q.dwx + tmp1 * q.dwy + tmp2 * q.dwz;
      p += mass.a * dot;
    }
    if (S.terms & kSolveB) {  // PressureSolveBoundary
      const T phi_b = T(S.rho0) / mass.c;
      const T dot = dijpj[0] * q.dwx + dijpj[1] * q.dwy + dijpj[2] * q.dwz;
      p += phi_b * dot;
    }
  }
  template <class A>
  __device__ void store(const A& a, int i, bool wm) {
    put(a, oP, i, p, wm);
  }
};

// PressureForce, PressureForceBoundary.
template <typename T>
struct Force {
  static constexpr int kTerms = kForce | kForceB;
  static constexpr bool kEmits = false;
  T rhoi1 = 0, pi = 0;
  T au = 0, av = 0, aw = 0;
  template <class A>
  __device__ void load(const A& a, int i) {
    rhoi1 = T(1) / ld<T>(a.rho, i);
    pi = ld<T>(a.p, i);
  }
  __device__ void pair(const IisphSrc& S, const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho V p
    T fac = T(0);
    if (S.terms & kForce) {  // PressureForce
      const T rhoj1 = T(1) / mass.b;
      fac = -mass.a * (pi * rhoi1 * rhoi1 + mass.d * rhoj1 * rhoj1);
      au += fac * q.dwx;
      av += fac * q.dwy;
      aw += fac * q.dwz;
    }
    if (S.terms & kForceB) {  // PressureForceBoundary
      fac = -pi * rhoi1 * rhoi1 * T(S.rho0) / mass.c;
      au += fac * q.dwx;
      av += fac * q.dwy;
      aw += fac * q.dwz;
    }
  }
  template <class A>
  __device__ void store(const A& a, int i, bool wm) {
    put(a, oAu, i, au, wm);
    put(a, oAv, i, av, wm);
    put(a, oAw, i, aw, wm);
  }
};

// Every pair in support of the dest at sorted position pos (particle i,
// its {x, y, z, h} di; active: pos is a dest) handed to ph.pair, source
// by source: src(s) is source s of n_src, and a source whose terms hold
// none of the set's is skipped (the same for every lane).  MODE kConsume:
// a warp whose dests all fit reads its lanes' listed entries in list
// order, kListBatch loads in flight a lane; a warp with a dest past the
// capacity walks, as MODE kWalk.  emit (a walk of an emitting set) also
// writes each dest's in-support candidates, in the order the body takes
// them, into the neighbour list, its count and the overflow counter.  g:
// the launch's args (nx ny nz, radius_scale, kfac, box, dim, cell, n_dest,
// nbr, count, cap; overflow where it emits).  Every lane of the warp must
// call it.
template <typename T, int KIND, bool PERIODIC, int MODE, class PhaseSet,
          class G, class Src>
__device__ __forceinline__ void sum_pairs(const G& g, const Src& src,
                                          int n_src, int pos, bool active,
                                          int i, const Rec<T>& di,
                                          PhaseSet& ph, bool emit) {
  const T rs = T(g.radius_scale), kfac = T(g.kfac);
  const walk::Box<T> box{{T(g.box[0]), T(g.box[1]), T(g.box[2])}};
  auto takes = [&](const IisphSrc& S) {
    return (S.terms & PhaseSet::kTerms) != 0;
  };

  bool walking = true;
  if (MODE == kConsume) {
    const int count = active ? g.count[pos] : 0;
    walking = __any_sync(walk::kFull, count > g.cap);
    // the list runs source by source: s is the source of the entries
    int s = 0;
    for (int c0 = 0; !walking && c0 < count; c0 += kListBatch) {
      int e[kListBatch];
#pragma unroll
      for (int u = 0; u < kListBatch; ++u)
        e[u] = c0 + u < count ? g.nbr[size_t(c0 + u) * g.n_dest + pos] : -1;
      int from[kListBatch];
      Rec<T> pj[kListBatch];
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (e[u] < 0) continue;
        while (s + 1 < n_src && e[u] >= src(s + 1).base) ++s;
        from[u] = s;
        // an entry of a source the call skips
        if (!takes(src(s))) {
          e[u] = -1;
          continue;
        }
        pj[u] = rec<T>(src(s).plane[kPos], e[u] - src(s).base);
      }
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (e[u] < 0) continue;
        const IisphSrc& S = src(from[u]);
        ph.pair(S, pair_of<T, KIND, PERIODIC>(di, pj[u], e[u] - S.base, box,
                                              kfac, g.dim));
      }
    }
  }
  if (walking) {
    const walk::Lane l = walk::lane_cell(g, active ? g.cell[i] : 0, active);
    int listed = 0;
    walk::Walker<T> walker;
    walker.begin();
    for (int s = 0; s < n_src; ++s) {
      const IisphSrc& S = src(s);
      if (!takes(S)) continue;  // the same for every lane
      auto body = [&](int k) {
        if constexpr (PhaseSet::kEmits) {
          if (emit) {
            if (listed < g.cap)
              g.nbr[size_t(listed) * g.n_dest + pos] = S.base + k;
            ++listed;
          }
        }
        ph.pair(S, pair_of<T, KIND, PERIODIC>(di, rec<T>(S.plane[kPos], k),
                                              k, box, kfac, g.dim));
      };
      if (PERIODIC)
        walk::walk_rows_periodic(g, S.cell_start, S.cell_end, S.plane[kPos],
                                 l, di, rs, box, walker, body);
      else
        walk::walk_rows(g, S.cell_start, S.cell_end, S.plane[kPos], l, 1,
                        di, rs, walker, body);
      walker.finish(body);
    }
    if constexpr (PhaseSet::kEmits) {
      if (emit && active) {
        g.count[pos] = listed;
        if (listed > g.cap) atomicAdd(g.overflow, 1);
      }
    }
  }
}

}  // namespace iisph
