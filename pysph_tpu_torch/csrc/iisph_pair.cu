// IISPH pair kernel for Hopper (sm_90a): the warp-coherent walk of
// csrc/cell_walk.cuh over the cell-sorted packed sources, on an open or a
// periodic grid.
//
// Replaces pysph_tpu/ops/resident.py::_pair_kernel_resident on the paths
// of IISPHScheme (pysph_tpu_torch/sph/iisph.py): the 2D dam break, the
// elliptical drop and the Taylor-Green vortex with --scheme iisph, where
// the TPU runs the scheme's groups in resident mode and its iterated
// pressure group inside a lax.while_loop.  The scheme's groups give six
// phase sets, one device functor each:
//
//   Density     NumberDensity, SummationDensity,
//               SummationDensityBoundary                   -> V rho
//   Advection   ComputeDII, ComputeDIIBoundary             -> dii0-2
//               ViscosityAcceleration(+Boundary)           -> au av aw
//   RhoAdv      ComputeRhoAdvection, ComputeRhoBoundary    -> rho_adv
//               ComputeAII, ComputeAIIBoundary             -> aii
//   Dijpj       ComputeDIJPJ                               -> dijpj0-2
//   Solve       PressureSolve, PressureSolveBoundary       -> p
//   Force       PressureForce, PressureForceBoundary       -> au av aw
//
// A per-source term mask (ops/iisph_pair.py) says which equations a
// source takes.  Any shape of csrc/shapes.cuh (QuinticSpline and Gaussian
// on the paths).  One launch computes every pair term of one dest array
// over all of its sources (at most 4) and writes each output once.
//
// Design, as csrc/tvf_pair.cu: thread t takes the dest at position t of
// the dest's sorted order, so a warp holds dests of one or a few nearby
// cells.  Each source is read from its packed copy (csrc/cell_pack.cuh,
// launched by this file's launch function just before the kernel), whose
// record planes are, as ops/iisph_pair.py PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: m rho V p
//   plane 2: u v w 0
//   plane 3: uadv vadv wadv 0
//   plane 4: dii0 dii1 dii2 piter
//   plane 5: dijpj0 dijpj1 dijpj2 0
// of which a source packs plane 0 and those its terms read (the pressure
// sweep's fluid source planes 0, 1, 4 and 5).  Each lane walks its own
// cells cx - 1 .. cx + 1 in each stencil row; on a periodic grid (the
// template flag PERIODIC) the rows wrap and every displacement is the
// minimum image (walk::walk_rows_periodic).  The walker hands the
// candidates in support to the pair body in rounds, one per lane; pair_of
// computes WIJ and DWIJ with the guards of the torch pair engine and the
// phase set's functor reads the records of the planes it needs and
// accumulates in registers.  The epilogue writes pre + sum under the
// write mask (Group real=True) and pre elsewhere.  No shared memory and
// no atomics, so the result is the same on every run.  Every dest read
// sees the value from before the phase; the planner refuses a set in
// which one equation reads what another accumulates.  The dest's own
// factors of a set are loaded once (the pressure sweep's
// m_i piter_i / rho_i^2 and dijpj_i).
//
// The linked launches (mode).  No group of IISPHScheme moves x y z h and
// the binning runs once an eval, so every launch of a dest after the
// first one that sees all its later sources walks the same pairs in the
// same order: up to 4 + 2k of them a step, k the pressure sweeps (2 to
// 30).  kWalk walks.  A walk of the Density or the Advection set with
// a.mode == kEmit (the first such launch of the dest, a runtime branch of
// the walking instantiation) also writes each dest's in-support
// candidates, in the order the body takes them, into the neighbour list:
// entry c of the dest at sorted position p is nbr[c * n_dest + p], a
// position in the numbering of all sources' copies (source s's position
// k is base_s + k), for c < cap; count[p] is the dest's number of pairs,
// which may exceed cap, and each such dest adds one to *overflow.
// kConsume (every later launch) packs its planes 1-5 (m rho V p, the
// velocities, dii and piter, dijpj: fresh every sweep) and reads plane 0
// from the emitting launch's copy; its sources are the emitter's, those it
// lacks with the term mask 0 (the fluid's ComputeDIJPJ against the dam
// break's fluid and wall): a warp whose dests all fit reads its lanes'
// listed records in list order, kListBatch loads in flight a lane,
// skipping the entries of a source of mask 0, and hands each to the same
// pair_of and functor as the walk, so its sums are the walk's bit for bit
// (built with ptxas's FMA contraction off, ops/build.py EXTRA_FLAGS, as
// tvf_pair); a warp with a dest past cap walks as kWalk, its sources of
// mask 0 skipped.
//
// What bounds it: operations.  A walking launch tests the candidates of
// the 3x3-cell stencil (a 16-byte record load, a support test each, the
// warp voting in rounds) and, per pair in support, computes the shape
// function and 10 to 40 flops on up to 9 source values; a consuming
// launch tests no candidate: its time is its pairs' arithmetic and their
// record loads (plane 0 from the emitter's copy, up to three planes from
// its own), the pressure sweep's four 16-byte records a pair the most.
// The bytes are a few records a particle.
//
// Interface: plain C, called through ctypes (ops/iisph_pair.py).  The
// launch function takes a host pointer to IisphArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack and
// then the kernel, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "shapes.cuh"

// The argument structs are at global scope: the exported C functions
// take them, and a type in an unnamed namespace would give those
// functions internal linkage.
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
// the record planes of the packed copy (above)
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
  int32_t terms;              // 0: a copy of the emitter the call skips
  int32_t base;  // its position 0 in the neighbour list's numbering
};

struct IisphArgs {
  const void *x, *y, *z, *h, *m, *rho, *u, *v, *w, *uadv, *vadv, *wadv,
      *dii0, *dii1, *dii2, *piter, *dijpj0, *dijpj1, *dijpj2, *p;  // dest
  const int32_t* cell;         // dest cell id, ix + nx * (iy + ny * iz)
  const int32_t* dorder;       // the dest's cell order: threads follow it
  const uint8_t* wmask;        // write mask (bool); null: every row
  const void* pre[kIisphOut];  // values before the phase; null: unused
  void* out[kIisphOut];
  // kEmit writes, kConsume reads: (cap, n_dest) entries, (n_dest) counts
  int32_t* nbr;
  int32_t* count;
  int32_t* overflow;  // kEmit: one per dest with more than cap pairs
  IisphSrc src[kIisphSources];
  double radius_scale, kfac;  // kfac: the kernel's sigma
  double dt;                  // the step's (the advected density)
  double box[3];  // the length of each periodic axis, 0 on the others
  int32_t n_dest, n_src, nx, ny, nz, dim, phase, dtype, kernel_kind,
      periodic, mode, cap;
  // the pack that fills the sources' planes: the launch function launches
  // it just before the kernel (n_src 0: none)
  PackArgs pack;
};

namespace {

using walk::Rec;
using walk::rec;

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
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
// minimum image on a periodic grid, r2, hij, WIJ and DWIJ.  Every mode
// computes its pairs here, so that a consuming launch's sums are the
// walk's bit for bit.
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
template <typename T>
__device__ __forceinline__ void put(const IisphArgs& a, int k, int i, T acc,
                                    bool wm) {
  if (a.out[k] == nullptr) return;
  const T pre = ld<T>(a.pre[k], i);
  static_cast<T*>(a.out[k])[i] = wm ? pre + acc : pre;
}

__host__ __device__ __forceinline__ int all_terms(const IisphArgs& a) {
  int t = 0;
  for (int s = 0; s < a.n_src; ++s) t |= a.src[s].terms;
  return t;
}

// Each functor: kEmits, whether its walk may write the neighbour list;
// load(a, i), the dest's values; pair(a, S, q), one pair in support;
// store(a, i, wm), the epilogue.

// NumberDensity, SummationDensity, SummationDensityBoundary.
template <typename T>
struct Density {
  static constexpr bool kEmits = true;
  T V = 0, rho = 0;
  __device__ void load(const IisphArgs&, int) {}
  __device__ void pair(const IisphArgs&, const IisphSrc& S,
                       const Pair<T>& q) {
    if (S.terms & kNden) V += q.w;
    if (S.terms & (kSden | kSdenB)) {
      const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho V p
      if (S.terms & kSden) rho += mass.a * q.w;
      if (S.terms & kSdenB) rho += T(S.rho0) / mass.c * q.w;
    }
  }
  __device__ void store(const IisphArgs& a, int i, bool wm) {
    put(a, oV, i, V, wm);
    put(a, oRho, i, rho, wm);
  }
};

// ComputeDII, ComputeDIIBoundary, ViscosityAcceleration(+Boundary).
template <typename T>
struct Advection {
  static constexpr bool kEmits = true;
  T rhoi = 0, rho_1 = 0;
  T ui[3] = {};
  T dii0 = 0, dii1 = 0, dii2 = 0, au = 0, av = 0, aw = 0;
  __device__ void load(const IisphArgs& a, int i) {
    rhoi = ld<T>(a.rho, i);
    rho_1 = T(1) / rhoi;
    if (all_terms(a) & (kVisc | kViscB)) {
      ui[0] = ld<T>(a.u, i);
      ui[1] = ld<T>(a.v, i);
      ui[2] = ld<T>(a.w, i);
    }
  }
  __device__ void pair(const IisphArgs&, const IisphSrc& S,
                       const Pair<T>& q) {
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
  __device__ void store(const IisphArgs& a, int i, bool wm) {
    put(a, oDii0, i, dii0, wm);
    put(a, oDii1, i, dii1, wm);
    put(a, oDii2, i, dii2, wm);
    put(a, oAu, i, au, wm);
    put(a, oAv, i, av, wm);
    put(a, oAw, i, aw, wm);
  }
};

// ComputeRhoAdvection, ComputeRhoBoundary, ComputeAII,
// ComputeAIIBoundary.
template <typename T>
struct RhoAdv {
  static constexpr bool kEmits = false;
  T adv[3] = {}, dii[3] = {};
  T fac = 0, dt = 0;  // fac = m_i / rho_i^2
  T rho_adv = 0, aii = 0;
  __device__ void load(const IisphArgs& a, int i) {
    const int t = all_terms(a);
    dt = T(a.dt);
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
  __device__ void pair(const IisphArgs&, const IisphSrc& S,
                       const Pair<T>& q) {
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
  __device__ void store(const IisphArgs& a, int i, bool wm) {
    put(a, oRhoAdv, i, rho_adv, wm);
    put(a, oAii, i, aii, wm);
  }
};

// ComputeDIJPJ: the source's -m_j piter_j / rho_j^2 DWIJ.
template <typename T>
struct Dijpj {
  static constexpr bool kEmits = false;
  T d0 = 0, d1 = 0, d2 = 0;
  __device__ void load(const IisphArgs&, int) {}
  __device__ void pair(const IisphArgs&, const IisphSrc& S,
                       const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho V p
    const T piter = rec<T>(S.plane[kDiiP], q.k).d;
    const T rho1 = T(1) / mass.b;
    const T fac = -mass.a * rho1 * rho1 * piter;
    d0 += fac * q.dwx;
    d1 += fac * q.dwy;
    d2 += fac * q.dwz;
  }
  __device__ void store(const IisphArgs& a, int i, bool wm) {
    put(a, oDijpj0, i, d0, wm);
    put(a, oDijpj1, i, d1, wm);
    put(a, oDijpj2, i, d2, wm);
  }
};

// PressureSolve, PressureSolveBoundary: one relaxed-Jacobi sweep's sum.
template <typename T>
struct Solve {
  static constexpr bool kEmits = false;
  T fac = 0;  // m_i piter_i / rho_i^2
  T dijpj[3] = {};
  T p = 0;
  __device__ void load(const IisphArgs& a, int i) {
    const T rho1 = T(1) / ld<T>(a.rho, i);
    if (all_terms(a) & kSolve)
      fac = ld<T>(a.m, i) * rho1 * rho1 * ld<T>(a.piter, i);
    dijpj[0] = ld<T>(a.dijpj0, i);
    dijpj[1] = ld<T>(a.dijpj1, i);
    dijpj[2] = ld<T>(a.dijpj2, i);
  }
  __device__ void pair(const IisphArgs&, const IisphSrc& S,
                       const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho V p
    if (S.terms & kSolve) {  // PressureSolve
      const Rec<T> dj = rec<T>(S.plane[kDiiP], q.k);     // dii piter
      const Rec<T> pj = rec<T>(S.plane[kDijpjP], q.k);   // dijpj
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
  __device__ void store(const IisphArgs& a, int i, bool wm) {
    put(a, oP, i, p, wm);
  }
};

// PressureForce, PressureForceBoundary.
template <typename T>
struct Force {
  static constexpr bool kEmits = false;
  T rhoi1 = 0, pi = 0;
  T au = 0, av = 0, aw = 0;
  __device__ void load(const IisphArgs& a, int i) {
    rhoi1 = T(1) / ld<T>(a.rho, i);
    pi = ld<T>(a.p, i);
  }
  __device__ void pair(const IisphArgs&, const IisphSrc& S,
                       const Pair<T>& q) {
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
  __device__ void store(const IisphArgs& a, int i, bool wm) {
    put(a, oAu, i, au, wm);
    put(a, oAv, i, av, wm);
    put(a, oAw, i, aw, wm);
  }
};

// The blocks of 128 threads an SM that a kernel's __launch_bounds__ asks
// for: double 4; float 8 for the density walk, 6 else.
template <typename T, class PhaseSet>
constexpr int blocks_for() {
  return sizeof(T) == 8 ? 4
         : std::is_same<PhaseSet, Density<T>>::value ? 8
                                                     : 6;
}

// One kernel for every phase set: MODE kWalk (with a.mode == kEmit, the
// walk of an emitting set also writes the list) or kConsume.
template <typename T, int KIND, bool PERIODIC, class PhaseSet, int MODE>
__global__ void __launch_bounds__(128, (blocks_for<T, PhaseSet>()))
    iisph_pair_kernel(const IisphArgs a) {
  // every lane stays to the end: the walk's votes take the whole warp
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pos < a.n_dest;
  const int i = active ? a.dorder[pos] : 0;

  Rec<T> di{};  // {xi, yi, zi, hi}
  PhaseSet ph;
  if (active) {
    di = {ld<T>(a.x, i), ld<T>(a.y, i), ld<T>(a.z, i), ld<T>(a.h, i)};
    ph.load(a, i);
  }
  const T rs = T(a.radius_scale), kfac = T(a.kfac);
  const walk::Box<T> box{{T(a.box[0]), T(a.box[1]), T(a.box[2])}};

  bool walking = true;
  if (MODE == kConsume) {
    const int count = active ? a.count[pos] : 0;
    walking = __any_sync(walk::kFull, count > a.cap);
    // the list runs source by source: s is the source of the entries
    int s = 0;
    for (int c0 = 0; !walking && c0 < count; c0 += kListBatch) {
      int e[kListBatch];
#pragma unroll
      for (int u = 0; u < kListBatch; ++u)
        e[u] = c0 + u < count ? a.nbr[size_t(c0 + u) * a.n_dest + pos] : -1;
      int from[kListBatch];
      Rec<T> pj[kListBatch];
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (e[u] < 0) continue;
        while (s + 1 < a.n_src && e[u] >= a.src[s + 1].base) ++s;
        from[u] = s;
        // an entry of a source the call skips
        if (a.src[s].terms == 0) {
          e[u] = -1;
          continue;
        }
        pj[u] = rec<T>(a.src[s].plane[kPos], e[u] - a.src[s].base);
      }
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (e[u] < 0) continue;
        const IisphSrc& S = a.src[from[u]];
        ph.pair(a, S,
                pair_of<T, KIND, PERIODIC>(di, pj[u], e[u] - S.base, box,
                                           kfac, a.dim));
      }
    }
  }
  if (walking) {
    const bool emit = MODE == kWalk && PhaseSet::kEmits && a.mode == kEmit;
    const walk::Lane l = walk::lane_cell(a, active ? a.cell[i] : 0, active);
    int listed = 0;
    walk::Walker<T> walker;
    walker.begin();
    for (int s = 0; s < a.n_src; ++s) {
      const IisphSrc& S = a.src[s];
      if (S.terms == 0) continue;  // the same for every lane
      auto body = [&](int k) {
        if (emit) {
          if (listed < a.cap)
            a.nbr[size_t(listed) * a.n_dest + pos] = S.base + k;
          ++listed;
        }
        ph.pair(a, S,
                pair_of<T, KIND, PERIODIC>(di, rec<T>(S.plane[kPos], k), k,
                                           box, kfac, a.dim));
      };
      if (PERIODIC)
        walk::walk_rows_periodic(a, S.cell_start, S.cell_end, S.plane[kPos],
                                 l, di, rs, box, walker, body);
      else
        walk::walk_rows(a, S.cell_start, S.cell_end, S.plane[kPos], l, 1,
                        di, rs, walker, body);
      walker.finish(body);
    }
    if (emit && active) {
      a.count[pos] = listed;
      if (listed > a.cap) atomicAdd(a.overflow, 1);
    }
  }
  if (active) ph.store(a, i, a.wmask == nullptr || a.wmask[i] != 0);
}

constexpr int kThreads = 128;

template <typename T, int KIND, bool PERIODIC, class PhaseSet>
void launch_set(const IisphArgs& a, int blocks, cudaStream_t stream) {
  if (a.mode == kConsume)
    iisph_pair_kernel<T, KIND, PERIODIC, PhaseSet, kConsume>
        <<<blocks, kThreads, 0, stream>>>(a);
  else
    iisph_pair_kernel<T, KIND, PERIODIC, PhaseSet, kWalk>
        <<<blocks, kThreads, 0, stream>>>(a);
}

// the Density set walks (or emits) only: no launch reads a list into it
template <typename T, int KIND, bool PERIODIC>
void launch_density(const IisphArgs& a, int blocks, cudaStream_t stream) {
  iisph_pair_kernel<T, KIND, PERIODIC, Density<T>, kWalk>
      <<<blocks, kThreads, 0, stream>>>(a);
}

template <typename T, int KIND, bool PERIODIC>
cudaError_t launch_walk(const IisphArgs& a, cudaStream_t stream) {
  const int blocks = (a.n_dest + kThreads - 1) / kThreads;
  switch (a.phase) {
    case kDensity:
      launch_density<T, KIND, PERIODIC>(a, blocks, stream);
      break;
    case kAdvection:
      launch_set<T, KIND, PERIODIC, Advection<T>>(a, blocks, stream);
      break;
    case kRhoAdvection:
      launch_set<T, KIND, PERIODIC, RhoAdv<T>>(a, blocks, stream);
      break;
    case kDijpjSet:
      launch_set<T, KIND, PERIODIC, Dijpj<T>>(a, blocks, stream);
      break;
    case kSolveSet:
      launch_set<T, KIND, PERIODIC, Solve<T>>(a, blocks, stream);
      break;
    default:
      launch_set<T, KIND, PERIODIC, Force<T>>(a, blocks, stream);
  }
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_kind(const IisphArgs& a, cudaStream_t stream) {
  return a.periodic ? launch_walk<T, KIND, true>(a, stream)
                    : launch_walk<T, KIND, false>(a, stream);
}

template <typename T>
cudaError_t launch(const IisphArgs& a, cudaStream_t stream) {
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    return launch_kind<T, decltype(kind)::value>(a, stream);
  });
}

// the phase sets whose walk emits, and those that consume (ops/
// iisph_pair.py EMITTING, CONSUMING)
bool emits(int phase) { return phase == kDensity || phase == kAdvection; }
bool consumes(int phase) { return phase >= kAdvection && phase <= kForceSet; }

bool args_ok(const IisphArgs& a) {
  const bool mode_ok =
      a.mode == kWalk ||
      (a.mode == kEmit && emits(a.phase) && a.overflow != nullptr) ||
      (a.mode == kConsume && consumes(a.phase));
  const bool list_ok = a.mode == kWalk ||
                       (a.cap >= 1 && a.nbr != nullptr &&
                        a.count != nullptr);
  bool bases_ok = a.n_src == 0 || a.src[0].base == 0;
  for (int s = 1; s < a.n_src && s < kIisphSources; ++s)
    bases_ok = bases_ok && a.src[s].base >= a.src[s - 1].base;
  // only a consuming launch skips a source (the emitter's it lacks)
  bool terms_ok = true;
  for (int s = 0; s < a.n_src && s < kIisphSources; ++s)
    terms_ok = terms_ok && (a.src[s].terms != 0 || a.mode == kConsume);
  return mode_ok && list_ok && bases_ok && terms_ok && a.n_src >= 0 &&
         a.n_src <= kIisphSources && a.nx >= 1 && a.ny >= 1 && a.nz >= 1 &&
         a.dim >= 1 && a.dim <= 3 && (a.dtype == 0 || a.dtype == 1) &&
         shapes::built_kind(a.kernel_kind) && a.phase >= kDensity &&
         a.phase <= kForceSet && a.dorder != nullptr && a.cell != nullptr &&
         pack::args_ok(a.pack) &&
         (a.pack.n_src == 0 || a.pack.dtype == a.dtype);
}

}  // namespace

extern "C" {

int iisph_pair_args_size() { return static_cast<int>(sizeof(IisphArgs)); }

int iisph_pair_launch(const IisphArgs* args, void* stream) {
  const IisphArgs a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* iisph_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
