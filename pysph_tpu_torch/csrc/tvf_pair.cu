// TVF pair kernel for Hopper (sm_90a): the warp-coherent walk of
// csrc/cell_walk.cuh over the cell-sorted packed sources, on an open or a
// periodic grid.
//
// Replaces pysph_tpu/ops/resident.py::_pair_kernel_resident on the paths
// of TVFScheme: the Taylor-Green vortex (examples/taylor_green.py), where
// the TPU runs it in resident mode on a box periodic in x and y, and the
// wall examples (poiseuille, couette, cavity, rayleigh_taylor,
// periodic_cylinders: Adami's walls, on a grid periodic in x or open);
// and of EDACScheme (taylor_green, cavity and dam_break_2d --scheme edac).
// The schemes' groups give two phase sets, one device functor each:
//
//   Density    SummationDensity                       -> V rho
//              ComputeAveragePressure (EDAC)          -> pavg nnbr
//   Momentum   MomentumEquationPressureGradient (TVF, with the background
//              pressure pb), MomentumEquationViscosity,
//              MomentumEquationArtificialStress,
//              MomentumEquationArtificialViscosity,
//              SolidWallNoSlipBC (the template flag WALL)
//                                          -> au av aw auhat avhat awhat
//              EDAC's MomentumEquationPressureGradient (p - pavg) and
//              MomentumEquation                -> au av aw (auhat ...)
//              EDACEquation                           -> ap
//              XSPHCorrection                         -> ax ay az
//
// A per-source term mask (ops/tvf_pair.py) says which equations a source
// takes.  Any shape of csrc/shapes.cuh (QuinticSpline
// on the path).  One launch computes every pair term of one dest array
// over all of its sources (at most 4) and writes each output once.
//
// Design, as csrc/gtvf_pair.cu: thread t takes the dest at position t of
// the dest's sorted order, so a warp holds dests of one or a few nearby
// cells.  Each source is read from its packed copy (csrc/cell_pack.cuh,
// launched by this file's launch function just before the kernel), whose
// record planes are, as ops/tvf_pair.py PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: m rho p V
//   plane 2: u v w 0
//   plane 3: uhat vhat what 0
//   plane 4: ug vg wg 0
// (plane 4: a wall's ghost velocity, which SolidWallNoSlipBC reads), of
// which a source packs plane 0 and those its terms read (the density
// launch plane 0 only).  Each lane walks its own cells cx - 1 .. cx + 1 in
// each stencil row; on a periodic grid (the template flag PERIODIC) the
// rows wrap and a row that crosses the grid's end on x is two ranges
// (walk::walk_rows_periodic), and every displacement, in the support test
// and in the pair, is the minimum image d - L rint(d / L) with the box
// lengths of the arguments.  The walker hands the candidates in support
// to the pair body in rounds, one per lane; pair_of computes WIJ and
// DWIJ with the guards of the torch pair engine and the phase set's
// functor reads the records of the planes it needs and accumulates in
// registers.  The epilogue writes pre + sum under the write mask (Group
// real=True) and pre elsewhere.  No shared memory and no atomics, so the
// result is the same on every run, and each lane sums its pairs in the
// order of the plain stencil walk.  Every dest read sees the value from
// before the phase; the planner refuses a phase set in which one equation
// reads what another accumulates.
//
// The linked pair (mode).  TVFScheme's groups between the density and
// the momentum group (the EOS, the wall velocity and pressure) move no
// x y z h and the binning runs once an eval, so the momentum launch would
// find the density launch's pairs again, in the same order.  kWalk walks
// (an unlinked call).  kEmit (the density launch) walks and also writes
// each dest's in-support candidates, in the order the body takes them,
// into the neighbour list: entry c of the dest at sorted position p is
// nbr[c * n_dest + p], a position in the numbering of all sources' copies
// (source s's position k is base_s + k), for c < cap; count[p] is the
// dest's number of pairs, which may exceed cap, and each such dest adds
// one to *overflow.  kConsume (the momentum launch) packs only planes 1-4
// (m rho p V, the velocities, the wall's ghost velocity: fresh after the
// density, EOS and wall groups) and reads plane 0 from the density
// launch's copy: a warp whose dests all
// fit reads its lanes' listed records in list order, kListBatch loads in
// flight a lane, and hands each to the same pair_of and functor as the
// walk, so its sums are the walk's bit for bit (built with ptxas's FMA
// contraction off, ops/build.py EXTRA_FLAGS: ptxas fuses a multiply and
// an add as each launch's schedule allows, which differed between the two
// launches on the wall examples); a warp with a dest past cap walks as
// kWalk.
//
// The wall (WALL).  SolidWallNoSlipBC is a runtime term like the others,
// but only in the Momentum instantiations with the template flag WALL,
// which the launch function picks where a source takes it: a momentum
// launch with no wall source (the Taylor-Green vortex) runs the code it
// ran before the term came, with the same registers.
//
// EDAC (the template flag EDAC of both functors).  EDACScheme's terms
// (kAvgp, kEmpg, kEmom, kEdacEq, kXsphCorr) are runtime terms of the
// instantiations with EDAC true, which only the library built with
// -DTVF_EDAC holds (ops/tvf_pair.py EDAC_FLAGS; built at its first
// launch): Density<T, true> in every mode, kConsume too (the cavity's
// mean-pressure group, between its density and its momentum group,
// reads the density launch's list), and Momentum<T, true, true>, with
// every TVF term as well, under a bound of its own.
// The default library holds the instantiations with EDAC false, the code
// of before, and refuses a launch with an EDAC term; the EDAC library
// refuses one without.  No term reads a plane the TVF terms do not
// pack: AVGP reads p (plane 1), EDACEquation and XSPHCorrection m rho p V
// and u v w.  ComputeAveragePressure counts every pair in support, W = 0
// at its edge too, so a pair exactly at the support's edge moves nnbr
// where the support test rounds otherwise.
//
// What bounds it: operations, and in each mode something else first.  A
// walking launch tests the candidates of the 3x3-cell stencil (~98 a
// particle at the path's 1.1 x 3h cells: a 16-byte record load, three
// minimum images and a support test each, the warp voting in rounds) and,
// per pair in support (~28), computes the shape function and 20 to 150
// flops on up to 12 source values; the bytes are a few records a
// particle.  The emitting density launch sums W alone, so its time is
// the walk's, plus a 4-byte list store a pair.  The consuming momentum
// launch tests no candidate: its time is its pairs' arithmetic and their
// 3 or 4 record loads (plane 0 from the emit's copy, planes 1-3 from its
// own), and its registers (the dest's 22 values and the accumulators)
// set how many warps hide those loads: it asks for 5 blocks an SM (96
// registers and a 20-byte spill in float), and each lane keeps
// kListBatch entries' loads in flight.
//
// Interface: plain C, called through ctypes (ops/tvf_pair.py).  The
// launch function takes a host pointer to TvfArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack and
// then the kernel, and returns cudaGetLastError().

#include <type_traits>

#include "wcsph_terms.cuh"

// The argument structs are at global scope: the exported C functions
// take them, and a type in an unnamed namespace would give those
// functions internal linkage.  (kMaxSources, 4, is csrc/wcsph_terms.cuh's.)
// term bits, as ops/tvf_pair.py
constexpr int kSden = 1, kMpg = 2, kVisc = 4, kMas = 8, kAvis = 16,
              kNoSlip = 32, kAvgp = 64, kEmpg = 128, kEmom = 256,
              kEdacEq = 512, kXsphCorr = 1024;
// the terms of the EDAC instantiations (ops/tvf_pair.py EDAC_TERMS)
constexpr int kEdacTerms = kAvgp | kEmpg | kEmom | kEdacEq | kXsphCorr;
// outputs in the order of ops/tvf_pair.py OUTPUTS
enum TvfOut {
  oV, oRho, oAu, oAv, oAw, oAuhat, oAvhat, oAwhat, oPavg, oNnbr, oAp, oAx,
  oAy, oAz, kTvfOut
};
// phase ids: the index of the phase set in ops/tvf_pair.py PHASE_SETS
enum TvfPhase { kDensity, kMomentum };
// the record planes of the packed copy (above)
enum TvfPlane { kPos, kMass, kVel, kHat, kGhost, kTvfPlanes };
// the modes, as ops/tvf_pair.py WALK, EMIT, CONSUME
constexpr int kWalk = 0, kEmit = 1, kConsume = 2;
// kConsume: listed entries whose loads a lane has in flight (at 5
// blocks an SM, tools_dev/list_batch.py: 4 fastest, against 2 and 1;
// PERF.md section 6 gives the times)
#ifndef LIST_BATCH
#define LIST_BATCH 4
#endif
constexpr int kListBatch = LIST_BATCH;
// float: the blocks of 128 threads an SM that __launch_bounds__ asks for,
// by mode (the density walk: 8); double: 4.  Each is the fastest of
// tools_dev/list_batch.py's sweep at nx=400; PERF.md section 6 gives
// that run's times, registers and spills for each bound.
#ifndef EMIT_BLOCKS
#define EMIT_BLOCKS 8
#endif
#ifndef MOMENTUM_BLOCKS
#define MOMENTUM_BLOCKS 6
#endif
#ifndef CONSUME_BLOCKS
#define CONSUME_BLOCKS 5
#endif
// float: the bound of the EDAC momentum instantiations, which hold the
// dest's pavg and four more accumulators (ap, ax ay az): 121 registers
// and no spill at 4 blocks (PERF.md section 6)
constexpr int kEdacMomentumBlocks = 4;
// the library of the EDAC instantiations (ops/tvf_pair.py EDAC_FLAGS)
#ifdef TVF_EDAC
constexpr bool kEdacLibrary = true;
#else
constexpr bool kEdacLibrary = false;
#endif

struct TvfSrc {
  // the packed copy's planes, in the source's cell order; null where the
  // source's terms read none of the plane's props (kConsume: plane 0 is
  // the emitting launch's copy)
  const void* plane[kTvfPlanes];
  const int32_t* cell_start;  // per cell: first position in the copy
  const int32_t* cell_end;    // per cell: one past the last
  double pb, nu, alpha, c0;   // MPG's pb, VISC's nu, AVIS's alpha and c0
  double noslip_nu;           // NOSLIP's nu
  double cs, edac_nu;         // EDACEquation's cs and nu
  double xsph_eps;            // XSPHCorrection's eps
  int32_t terms;
  int32_t base;  // its position 0 in the neighbour list's numbering
};

struct TvfArgs {
  const void *x, *y, *z, *h, *m, *rho, *p, *V, *u, *v, *w, *uhat, *vhat,
      *what, *pavg;          // dest
  const int32_t* cell;       // dest cell id, ix + nx * (iy + ny * iz)
  const int32_t* dorder;     // the dest's cell order: threads follow it
  const uint8_t* wmask;      // write mask (bool); null: every row
  const void* pre[kTvfOut];  // values before the phase; null: unused
  void* out[kTvfOut];
  // kEmit writes, kConsume reads: (cap, n_dest) entries, (n_dest) counts
  int32_t* nbr;
  int32_t* count;
  int32_t* overflow;  // kEmit: one per dest with more than cap pairs
  TvfSrc src[kMaxSources];
  double radius_scale, kfac;  // kfac: the kernel's sigma
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
// position k whose {x, y, z, h} record is pj: the minimum image on a
// periodic grid, r2, hij, WIJ and DWIJ.  Every mode computes its pairs
// here, so that a consuming launch's sums are the walk's bit for bit.
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
  wcsph::shape<T, KIND>(rij * h1, wq, dwq);
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
__device__ __forceinline__ void put(const TvfArgs& a, int k, int i, T acc,
                                    bool wm) {
  if (a.out[k] == nullptr) return;
  const T pre = ld<T>(a.pre[k], i);
  static_cast<T*>(a.out[k])[i] = wm ? pre + acc : pre;
}

__host__ __device__ __forceinline__ int all_terms(const TvfArgs& a) {
  int t = 0;
  for (int s = 0; s < a.n_src; ++s) t |= a.src[s].terms;
  return t;
}

// Each functor: kDensity, whether it is the density set; load(a, i), the
// dest's values; pair(a, S, q), one pair in support; store(a, i, wm), the
// epilogue.  EDAC: the instantiation that takes ComputeAveragePressure.
template <typename T, bool EDAC>
struct Density {
  static constexpr bool kDensity = true;
  T mi = 0;
  T V = 0, rho = 0;
  T pavg = 0, nnbr = 0;  // EDAC
  __device__ void load(const TvfArgs& a, int i) {
    if (!EDAC || (all_terms(a) & kSden)) mi = ld<T>(a.m, i);
  }
  __device__ void pair(const TvfArgs&, const TvfSrc& S, const Pair<T>& q) {
    if (EDAC && (S.terms & kAvgp)) {  // ComputeAveragePressure
      pavg += rec<T>(S.plane[kMass], q.k).c;
      nnbr += T(1);
    }
    if (!(S.terms & kSden)) return;  // SummationDensity
    V += q.w;
    rho += mi * q.w;
  }
  __device__ void store(const TvfArgs& a, int i, bool wm) {
    put(a, oV, i, V, wm);
    put(a, oRho, i, rho, wm);
    if (EDAC) {
      put(a, oPavg, i, pavg, wm);
      put(a, oNnbr, i, nnbr, wm);
    }
  }
};

// The dest's parts are loaded once: 1 / m, (1 / V)^2, rho, p, the
// velocity, and for the artificial stress rho u[c] (uhat - u)[d].  WALL:
// the instantiation that takes SolidWallNoSlipBC (kNoSlip); EDAC: the one
// that takes EDACScheme's terms (and pavg).
template <typename T, bool WALL, bool EDAC>
struct Momentum {
  static constexpr bool kDensity = false;
  static constexpr int kWall = WALL ? kNoSlip : 0;
  // the EDAC terms that read the volume factor, p, and the velocity
  static constexpr int kEdacVfac = EDAC ? kEmpg | kEmom | kEdacEq : 0;
  static constexpr int kEdacVel = EDAC ? kEdacEq | kXsphCorr : 0;
  T mi1 = 0, vi2 = 0, rhoi = 0, pi = 0;
  T ui[3] = {}, ai[3][3] = {};  // ai[c][d] = rhoi ui[c] (uhati - ui)[d]
  T au = 0, av = 0, aw = 0, auhat = 0, avhat = 0, awhat = 0;
  T pavgi = 0, ap = 0, ax = 0, ay = 0, az = 0;  // EDAC
  __device__ void load(const TvfArgs& a, int i) {
    const int t = all_terms(a);
    if (t & (kMpg | kVisc | kMas | kWall | kEdacVfac)) {
      mi1 = T(1) / ld<T>(a.m, i);
      const T vi = T(1) / ld<T>(a.V, i);
      vi2 = vi * vi;
    }
    rhoi = ld<T>(a.rho, i);
    if (t & (kMpg | kEdacVfac)) pi = ld<T>(a.p, i);
    if (EDAC && (t & kEmpg)) pavgi = ld<T>(a.pavg, i);
    if (t & (kVisc | kMas | kAvis | kWall | kEdacVel)) {
      ui[0] = ld<T>(a.u, i);
      ui[1] = ld<T>(a.v, i);
      ui[2] = ld<T>(a.w, i);
    }
    if (t & kMas) {
      const T di[3] = {ld<T>(a.uhat, i) - ui[0], ld<T>(a.vhat, i) - ui[1],
                       ld<T>(a.what, i) - ui[2]};
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int d = 0; d < 3; ++d) ai[c][d] = rhoi * ui[c] * di[d];
    }
  }
  __device__ void pair(const TvfArgs&, const TvfSrc& S, const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);  // m rho p V
    const T rhoj = mass.b;
    const T vj = T(1) / mass.d;
    const T vfac = mi1 * (vi2 + vj * vj);
    const T eps = T(0.01) * q.hij * q.hij;
    Rec<T> vel{};
    if (S.terms & (kVisc | kMas | kAvis | kEdacVel))
      vel = rec<T>(S.plane[kVel], q.k);
    const T vij[3] = {ui[0] - vel.a, ui[1] - vel.b, ui[2] - vel.c};
    if (S.terms & kMpg) {  // MomentumEquationPressureGradient
      const T pij = (rhoj * pi + rhoi * mass.c) / (rhoj + rhoi);
      const T tmp = -pij * vfac;
      au += tmp * q.dwx;
      av += tmp * q.dwy;
      aw += tmp * q.dwz;
      const T tmph = T(-S.pb) * vfac;
      auhat += tmph * q.dwx;
      avhat += tmph * q.dwy;
      awhat += tmph * q.dwz;
    }
    if (S.terms & kVisc) {  // MomentumEquationViscosity
      const T etai = T(S.nu) * rhoi, etaj = T(S.nu) * rhoj;
      const T etaij = T(2) * (etai * etaj) / (etai + etaj);
      const T fij = q.dwx * q.xij + q.dwy * q.yij + q.dwz * q.zij;
      const T tmp = vfac * etaij * fij / (q.r2 + eps);
      au += tmp * vij[0];
      av += tmp * vij[1];
      aw += tmp * vij[2];
    }
    if (S.terms & kMas) {  // MomentumEquationArtificialStress
      const Rec<T> hat = rec<T>(S.plane[kHat], q.k);
      const T uj[3] = {vel.a, vel.b, vel.c};
      const T dj[3] = {hat.a - uj[0], hat.b - uj[1], hat.c - uj[2]};
      const T dw[3] = {q.dwx, q.dwy, q.dwz};
      T res[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T acc = T(0);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          acc += (ai[c][d] + rhoj * uj[c] * dj[d]) * dw[d];
        res[c] = T(0.5) * acc;
      }
      au += vfac * res[0];
      av += vfac * res[1];
      aw += vfac * res[2];
    }
    if (S.terms & kAvis) {  // MomentumEquationArtificialViscosity
      const T vdotx = vij[0] * q.xij + vij[1] * q.yij + vij[2] * q.zij;
      if (vdotx < T(0)) {
        const T rhoij = T(0.5) * (rhoi + rhoj);
        const T rhoij1 = T(1) / (rhoij != T(0) ? rhoij : T(1));
        const T muij = q.hij * vdotx / (q.r2 + eps);
        const T piij = -T(S.alpha) * T(S.c0) * muij * mass.a * rhoij1;
        au += -piij * q.dwx;
        av += -piij * q.dwy;
        aw += -piij * q.dwz;
      }
    }
    if (WALL && (S.terms & kNoSlip)) {  // SolidWallNoSlipBC
      const Rec<T> ghost = rec<T>(S.plane[kGhost], q.k);  // ug vg wg
      const T etai = T(S.noslip_nu) * rhoi, etaj = T(S.noslip_nu) * rhoj;
      const T etaij = T(2) * (etai * etaj) / (etai + etaj);
      const T fij = q.xij * q.dwx + q.yij * q.dwy + q.zij * q.dwz;
      const T tmp = vfac * (etaij * fij / (q.r2 + eps));
      au += tmp * (ui[0] - ghost.a);
      av += tmp * (ui[1] - ghost.b);
      aw += tmp * (ui[2] - ghost.c);
    }
    if (EDAC) edac_pair(S, q, mass, vfac, eps, vij);
  }
  // EDACScheme's terms of one pair: mass = {m rho p V} of the source
  __device__ void edac_pair(const TvfSrc& S, const Pair<T>& q,
                            const Rec<T>& mass, T vfac, T eps,
                            const T (&vij)[3]) {
    const T rhoj = mass.b;
    if (S.terms & kEmpg) {  // MomentumEquationPressureGradient (EDAC)
      const T pij = (rhoj * (pi - pavgi) + rhoi * (mass.c - pavgi)) /
                    (rhoj + rhoi);
      const T tmp = -pij * vfac;
      au += tmp * q.dwx;
      av += tmp * q.dwy;
      aw += tmp * q.dwz;
      const T tmph = T(-S.pb) * vfac;
      auhat += tmph * q.dwx;
      avhat += tmph * q.dwy;
      awhat += tmph * q.dwz;
    }
    if (S.terms & kEmom) {  // MomentumEquation (EDAC)
      const T pij = (rhoj * pi + rhoi * mass.c) / (rhoj + rhoi);
      const T tmp = -pij * vfac;
      au += tmp * q.dwx;
      av += tmp * q.dwy;
      aw += tmp * q.dwz;
    }
    if (S.terms & kEdacEq) {  // EDACEquation
      const T etaij = T(2) * T(S.edac_nu) * (rhoi * rhoj) / (rhoi + rhoj);
      const T vdotdw = q.dwx * vij[0] + q.dwy * vij[1] + q.dwz * vij[2];
      const T cs = T(S.cs);
      ap += rhoi / rhoj * cs * cs * mass.a * vdotdw;
      const T xdotdw = q.dwx * q.xij + q.dwy * q.yij + q.dwz * q.zij;
      ap += vfac * etaij * xdotdw / (q.r2 + eps) * (pi - mass.c);
    }
    if (S.terms & kXsphCorr) {  // XSPHCorrection
      const T rhoij = T(0.5) * (rhoi + rhoj);
      const T rhoij1 = T(1) / (rhoij != T(0) ? rhoij : T(1));
      const T tmp = -T(S.xsph_eps) * mass.a * q.w * rhoij1;
      ax += tmp * vij[0];
      ay += tmp * vij[1];
      az += tmp * vij[2];
    }
  }
  __device__ void store(const TvfArgs& a, int i, bool wm) {
    put(a, oAu, i, au, wm);
    put(a, oAv, i, av, wm);
    put(a, oAw, i, aw, wm);
    put(a, oAuhat, i, auhat, wm);
    put(a, oAvhat, i, avhat, wm);
    put(a, oAwhat, i, awhat, wm);
    if (EDAC) {
      put(a, oAp, i, ap, wm);
      put(a, oAx, i, ax, wm);
      put(a, oAy, i, ay, wm);
      put(a, oAz, i, az, wm);
    }
  }
};

// The blocks of 128 threads an SM that a kernel's __launch_bounds__ asks
// for.
template <typename T, bool DENSITY, int MODE>
constexpr int blocks_of() {
  return sizeof(T) == 8    ? 4
         : MODE == kEmit    ? EMIT_BLOCKS
         : MODE == kConsume ? CONSUME_BLOCKS
         : DENSITY          ? 8
                            : MOMENTUM_BLOCKS;
}

// The same for a phase set: the EDAC momentum instantiations have a
// bound of their own.
template <typename T, class PhaseSet, int MODE>
constexpr int blocks_for() {
  return std::is_same<PhaseSet, Momentum<T, true, true>>::value &&
                 sizeof(T) == 4
             ? kEdacMomentumBlocks
             : blocks_of<T, PhaseSet::kDensity, MODE>();
}

// One kernel for both phase sets and every mode: kEmit only with Density,
// kConsume with Momentum and with the EDAC Density (the launch function's
// dispatch).
template <typename T, int KIND, bool PERIODIC, class PhaseSet, int MODE>
__global__ void __launch_bounds__(128, (blocks_for<T, PhaseSet, MODE>()))
    tvf_pair_kernel(const TvfArgs a) {
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
        pj[u] = rec<T>(a.src[s].plane[kPos], e[u] - a.src[s].base);
      }
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (e[u] < 0) continue;
        const TvfSrc& S = a.src[from[u]];
        ph.pair(a, S,
                pair_of<T, KIND, PERIODIC>(di, pj[u], e[u] - S.base, box,
                                           kfac, a.dim));
      }
    }
  }
  if (walking) {
    const walk::Lane l = walk::lane_cell(a, active ? a.cell[i] : 0, active);
    int listed = 0;
    walk::Walker<T> walker;
    walker.begin();
    for (int s = 0; s < a.n_src; ++s) {
      const TvfSrc& S = a.src[s];
      auto body = [&](int k) {
        if (MODE == kEmit) {
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
    if (MODE == kEmit && active) {
      a.count[pos] = listed;
      if (listed > a.cap) atomicAdd(a.overflow, 1);
    }
  }
  if (active) ph.store(a, i, a.wmask == nullptr || a.wmask[i] != 0);
}

constexpr int kThreads = 128;

// the momentum launch walks or consumes
template <typename T, int KIND, bool PERIODIC, bool WALL, bool EDAC>
void launch_momentum(const TvfArgs& a, int blocks, cudaStream_t stream) {
  using M = Momentum<T, WALL, EDAC>;
  if (a.mode == kConsume)
    tvf_pair_kernel<T, KIND, PERIODIC, M, kConsume>
        <<<blocks, kThreads, 0, stream>>>(a);
  else
    tvf_pair_kernel<T, KIND, PERIODIC, M, kWalk>
        <<<blocks, kThreads, 0, stream>>>(a);
}

// the density launch walks or emits (and, in the EDAC library, consumes)
template <typename T, int KIND, bool PERIODIC, bool EDAC>
void launch_density(const TvfArgs& a, int blocks, cudaStream_t stream) {
  using D = Density<T, EDAC>;
  if (a.mode == kEmit)
    tvf_pair_kernel<T, KIND, PERIODIC, D, kEmit>
        <<<blocks, kThreads, 0, stream>>>(a);
#ifdef TVF_EDAC
  else if (a.mode == kConsume)
    tvf_pair_kernel<T, KIND, PERIODIC, D, kConsume>
        <<<blocks, kThreads, 0, stream>>>(a);
#endif
  else
    tvf_pair_kernel<T, KIND, PERIODIC, D, kWalk>
        <<<blocks, kThreads, 0, stream>>>(a);
}

// The default library: the momentum launch takes the WALL instantiation
// where a source takes SolidWallNoSlipBC.  The EDAC library: the EDAC
// instantiations, the momentum's with the wall.
template <typename T, int KIND, bool PERIODIC>
cudaError_t launch_walk(const TvfArgs& a, cudaStream_t stream) {
  const int blocks = (a.n_dest + kThreads - 1) / kThreads;
#ifdef TVF_EDAC
  if (a.phase == kDensity)
    launch_density<T, KIND, PERIODIC, true>(a, blocks, stream);
  else
    launch_momentum<T, KIND, PERIODIC, true, true>(a, blocks, stream);
#else
  if (a.phase == kDensity)
    launch_density<T, KIND, PERIODIC, false>(a, blocks, stream);
  else if (all_terms(a) & kNoSlip)
    launch_momentum<T, KIND, PERIODIC, true, false>(a, blocks, stream);
  else
    launch_momentum<T, KIND, PERIODIC, false, false>(a, blocks, stream);
#endif
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_kind(const TvfArgs& a, cudaStream_t stream) {
  return a.periodic ? launch_walk<T, KIND, true>(a, stream)
                    : launch_walk<T, KIND, false>(a, stream);
}

template <typename T>
cudaError_t launch(const TvfArgs& a, cudaStream_t stream) {
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    return launch_kind<T, decltype(kind)::value>(a, stream);
  });
}

bool args_ok(const TvfArgs& a) {
  const int terms =
      a.n_src >= 0 && a.n_src <= kMaxSources ? all_terms(a) : 0;
  const bool mode_ok =
      a.mode == kWalk ||
      (a.mode == kEmit && a.phase == kDensity && a.overflow != nullptr) ||
      (a.mode == kConsume &&
       (a.phase == kMomentum || (kEdacLibrary && (terms & kAvgp))));
  // each library runs the terms of its instantiations
  const bool library_ok = ((terms & kEdacTerms) != 0) == kEdacLibrary;
  const bool list_ok = a.mode == kWalk ||
                       (a.cap >= 1 && a.nbr != nullptr &&
                        a.count != nullptr);
  bool bases_ok = a.n_src == 0 || a.src[0].base == 0;
  for (int s = 1; s < a.n_src && s < kMaxSources; ++s)
    bases_ok = bases_ok && a.src[s].base >= a.src[s - 1].base;
  return mode_ok && library_ok && list_ok && bases_ok && a.n_src >= 0 &&
         a.n_src <= kMaxSources && a.nx >= 1 && a.ny >= 1 && a.nz >= 1 &&
         a.dim >= 1 && a.dim <= 3 && (a.dtype == 0 || a.dtype == 1) &&
         shapes::built_kind(a.kernel_kind) && a.phase >= kDensity &&
         a.phase <= kMomentum && a.dorder != nullptr && a.cell != nullptr &&
         pack::args_ok(a.pack) &&
         (a.pack.n_src == 0 || a.pack.dtype == a.dtype);
}

}  // namespace

extern "C" {

int tvf_pair_args_size() { return static_cast<int>(sizeof(TvfArgs)); }

int tvf_pair_launch(const TvfArgs* args, void* stream) {
  const TvfArgs a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* tvf_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
