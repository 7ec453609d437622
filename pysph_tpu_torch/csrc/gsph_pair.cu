// Godunov SPH pair kernel for Hopper (sm_90a): GSPHScheme's gradients and
// its Riemann-solver accelerations with per-particle smoothing lengths,
// over the warp-coherent walk of csrc/cell_walk.cuh and the cell-sorted
// packed sources of csrc/cell_pack.cuh, on an open or a periodic grid.
//
// Replaces pysph_tpu/ops/pallas_engine.py::_pair_kernel_compact (:1160,
// its pallas_call :1867) for GSPHScheme's two pair phases (the accuracy
// test, the hydrostatic box and the shock tube's --scheme gsph of
// examples/gas_dynamics/): the resident engine turns itself off for an
// update_nnps group, and GSPHScheme's evaluation has two.  Two phase sets,
// one device functor each:
//
//   Gradients     GSPHGradients: DWI at the dest's h
//                 -> px py pz ux uy uz vx vy vz wx wy wz
//   Acceleration  GSPHAcceleration: along each pair's line the left
//                 (source) and right (dest) states reconstructed from the
//                 gradients under the monotonicity limiter (0 first order,
//                 1 I02, 2 IwIn), the specific-volume integrals of the
//                 interpolation (0 delta, 1 linear, 2 cubic), a Riemann
//                 problem solved by one of the eleven solvers of
//                 csrc/riemann.cuh (with the hybrid blend towards HLLSY),
//                 DWI, DWJ and DWIJ at the dest's, the source's and the
//                 mean h, and the ADKE-style conduction where g1 or g2 is
//                 set -> au av aw ae
//
// Every branch of GSPHAcceleration is a runtime branch on a constant of
// the launch (uniform over it: the solver, the limiter, the
// interpolation, interface_zero, hybrid, the conduction), so that the
// library holds one kernel a set, dtype, kind and grid; the solvers'
// code is in every acceleration kernel once.  The step's dt (the
// reconstruction's time centring, fl = 1 - csj dt sij) and t (the hybrid
// blend exp(-blend_alpha t / tf)) are read from the card where the
// arguments give their addresses (dt_at, t_at: the solver's chunk, whose
// CUDA graph then replays each step's own), else taken from the host.
//
// h varies per particle: the walk's support test is r2 < (rs max(hi,
// hj))^2 (walk::in_support), as the torch pair engine's.  The self-pair
// is in support and takes the near branch (RIJ < 1e-14: the unit vector
// 0, sij = 1 / (RIJ + EPS)), as the plain version's.  The shape is any
// kind of csrc/shapes.cuh (the Gaussian, kind 2, is the scheme's
// default), a template parameter: this library holds kinds 0-3 and each
// later kind is a library of its own.  One launch computes the pair terms
// of one dest array over all its sources (at most 4) and writes each
// output once: pre + sum under the write mask, pre elsewhere; with a
// non-null count, each dest's number of pairs in support.
//
// Design, as csrc/gasd_pair.cu's walk: thread t takes the dest at
// position t of the dest's sorted order, so a warp holds dests of one or
// a few nearby cells; each lane walks its own cells cx - 1 .. cx + 1 in
// each stencil row (on a periodic grid, the template flag PERIODIC, the
// rows wrap and each displacement is the minimum image); the walker
// hands the candidates in support to the pair body in rounds, one per
// lane.  Each source is read from its packed copy (launched by this
// file's launch function just before the kernel), whose record planes
// are, as ops/gsph_pair.py PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: u v w m
//   plane 2: rho p cs e
//   plane 3: div grhox grhoy grhoz
//   plane 4: px py pz ux
//   plane 5: uy uz vx vy
//   plane 6: vz wx wy wz
// of which the gradients pack planes 0-2, the acceleration all seven.
// Every run sums in the order of the plain stencil walk.  Built with
// -fmad=false (ops/build.py EXTRA_FLAGS): the support test and every pair
// term round each operation as the plain version's, so the pairs and each
// dest's count are exactly its.
//
// The linked pair (the mode a.mode, uniform over the launch: kWalk, the
// call above; kEmit, the gradients; kConsume, the acceleration).  Nothing
// between GSPHScheme's gradients group and its acceleration group writes
// a prop of planes 0-2 (ops/pair_engine.py link_pairs), so the gradients
// launch (kEmit) walks as above and also writes its neighbour list: entry c
// of the dest at sorted position p is nbr[c * n_dest + p], source s's
// position k numbered base_s + k, for c < cap, lcount[p] its pairs (which
// may exceed cap: each such dest adds one to *overflow).  The acceleration
// launch (kConsume) packs only planes 3-6 and reads planes 0-2 from the
// gradients launch's copy; a warp whose dests all fit reads their listed
// pairs in list order, handing each to the same pair_of and functor as the
// walk, so its sums are the walk's bit for bit; a warp with a dest past
// cap walks.  (Staging each block's listed sources in shared memory by
// bulk asynchronous copies, its stencil rows' ranges of the copy, was
// measured 2-6% slower than these reads through L1 at the accuracy test's
// 256^2, PERF.md, and is not kept.)
//
// What bounds it: operations.  Per pair in support the gradients
// evaluate the shape once and ~40 flops; the acceleration the gradient at
// three smoothing lengths, ~150 flops of reconstruction and sums, and the
// Riemann solver: a few tens of flops and square roots for the
// approximate ones, and for the exact solver two pow-based pressure
// functions a Newton trip, niter trips (20 in the shock tube).  The pair
// body reads each source record where it uses it, so a value is held only
// while it is in use.  The acceleration kernel's __launch_bounds__ asks
// for GSPH_ACC_BLOCKS_F32 (float: 4, 128 registers, a few spilled bytes)
// or GSPH_ACC_BLOCKS_F64 (double: 2) blocks an SM, the fastest of a
// measured sweep (tools_dev/list_batch.py gsph_pair, PERF.md).
//
// Interface: plain C, called through ctypes (ops/gsph_pair.py).  The
// launch function takes a host pointer to GsphArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack and
// then the kernel, and returns cudaGetLastError().  gsph_pair_riemann runs
// one solver elementwise (RiemannArgs), the probe that holds the device
// solvers to the torch ones.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "riemann.cuh"
#include "shapes.cuh"

constexpr int kGsphSources = 4;
// the acceleration kernel's blocks of 128 threads an SM (__launch_bounds__)
#ifndef GSPH_ACC_BLOCKS_F32
#define GSPH_ACC_BLOCKS_F32 4
#endif
#ifndef GSPH_ACC_BLOCKS_F64
#define GSPH_ACC_BLOCKS_F64 2
#endif
// modes, as ops/gsph_pair.py WALK, EMIT, CONSUME
enum GsphMode { kWalk, kEmit, kConsume };
// term bits, as ops/gsph_pair.py GRAD, ACC
constexpr int kGrad = 1, kAcc = 2;
// outputs in the order of ops/gsph_pair.py OUTPUTS
enum GsphOut {
  oPx, oPy, oPz, oUx, oUy, oUz, oVx, oVy, oVz, oWx, oWy, oWz, oAu, oAv,
  oAw, oAe, kGsphOut
};
// phase ids: the index of the phase set in ops/gsph_pair.py PHASE_SETS
enum GsphPhase { kGradients, kAcceleration };
// the record planes of a packed copy
enum GsphPlane {
  kPos, kVelM, kThermo, kDivGrho, kGrad4, kGrad5, kGrad6, kGsphPlanes
};

// The argument structs are at global scope: the exported C functions take
// them, and a type in an unnamed namespace would give those functions
// internal linkage.
struct GsphSrc {
  // the packed copy's planes, in the source's cell order; null where the
  // set reads none of the plane's props
  const void* plane[kGsphPlanes];
  const int32_t* cell_start;  // per cell: first position in the copy
  const int32_t* cell_end;    // per cell: one past the last
  int32_t terms;
  int32_t base;
};

struct GsphArgs {
  // dest: as ops/gsph_pair.py _DEST_PROPS
  const void *x, *y, *z, *h, *rho, *p, *cs, *e, *div, *u, *v, *w, *grhox,
      *grhoy, *grhoz, *px, *py, *pz, *ux, *uy, *uz, *vx, *vy, *vz, *wx, *wy,
      *wz;
  const int32_t* cell;         // dest cell id, ix + nx * (iy + ny * iz)
  const int32_t* dorder;       // the dest's cell order: threads follow it
  const uint8_t* wmask;        // write mask (bool); null: every row
  const void* pre[kGsphOut];   // values before the phase; null: unused
  void* out[kGsphOut];
  int32_t* count;              // non-null: each dest's pairs in support
  GsphSrc src[kGsphSources];
  const double* dt_at;         // non-null: the step's dt on the card
  const double* t_at;          // non-null: the step's t on the card
  double radius_scale, kfac;   // kfac: the kernel's sigma
  double g1, g2, gamma, blend_alpha, tf, dt, t;
  double box[3];  // the length of each periodic axis, 0 on the others
  int32_t n_dest, n_src, nx, ny, nz, dim, phase, dtype, kernel_kind,
      periodic;
  // GSPHAcceleration's branches
  int32_t rsolver, niter, monotonicity, interpolation, interface_zero,
      hybrid, conduction;
  // the linked pair (see the top): the mode, the list's entries a dest,
  // the list (cap, n_dest), each dest's count and kEmit's count of dests
  // past cap
  int32_t mode, cap;
  int32_t* nbr;
  int32_t* lcount;
  int32_t* overflow;
  // the pack that fills the sources' planes: the launch function launches
  // it just before the kernel
  PackArgs pack;
};

// The probe: solver `method` on n states, elementwise.
struct RiemannArgs {
  const void *rhol, *rhor, *pl, *pr, *ul, *ur;
  void *pstar, *ustar;
  double gamma;
  int32_t n, method, niter, dtype;
};

namespace {

using walk::Rec;
using walk::rec;

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

// A source's planes as the pair body reads them: its packed copy.
struct CopyPlanes {
  const void* const* plane;
  template <typename T>
  __device__ __forceinline__ Rec<T> rec(int q, int k) const {
    return walk::rec<T>(plane[q], k);
  }
};

template <typename T>
__device__ __forceinline__ T hpow(T h1, int dim) {
  return dim == 1 ? h1 : dim == 2 ? h1 * h1 : h1 * h1 * h1;
}

// torch.sign: 0 at 0 and at a NaN
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return T((T(0) < x) - (x < T(0)));
}

// One pair in support: k, the source particle's position in its packed
// copy; XIJ (the minimum image on a periodic grid), RIJ, 1 / RIJ (0 at
// RIJ = 0, as the torch pair engine's RINV) and the source's h.
template <typename T>
struct Pair {
  int k;
  T xij, yij, zij, rij, rinv, hj;
};

template <typename T, bool PERIODIC>
__device__ __forceinline__ Pair<T> pair_of(const Rec<T>& di,
                                           const Rec<T>& pj, int k,
                                           const walk::Box<T>& box) {
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
  const T r2 = q.xij * q.xij + q.yij * q.yij + q.zij * q.zij;
  q.rinv = r2 > T(1e-24) ? T(1) / sqrt(r2) : T(0);
  q.rij = r2 * q.rinv;
  q.hj = pj.d;
  return q;
}

// The kernel of shape KIND at one smoothing length h: h1 = 1 / h (1 where
// h <= 0), fac = sigma h1^dim, as the torch pair engine's _kparts.
template <typename T, int KIND>
struct AtH {
  T h1, fac;
  __device__ __forceinline__ void set(T h, T kfac, int dim) {
    h1 = T(1) / (h > T(0) ? h : T(1));
    fac = kfac * hpow(h1, dim);
  }
  // the gradient's factor: DW = grad(q) * XIJ (0 where RIJ <= 1e-12)
  __device__ __forceinline__ T grad(const Pair<T>& q) const {
    T w, dw;
    shapes::shape<T, KIND>(q.rij * h1, w, dw);
    return q.rij > T(1e-12) ? dw * fac * h1 * q.rinv : T(0);
  }
};

// GSPHGradients: DWI at the dest's h.
template <typename T, int KIND>
struct Gradients {
  static constexpr int kBlocks = 4;
  static constexpr bool kConsumes = false;
  T ui = 0, vi = 0, wi = 0, pi = 0;
  AtH<T, KIND> at{};
  T acc[12] = {};
  __device__ void load(const GsphArgs& a, int i) {
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    pi = ld<T>(a.p, i);
    at.set(ld<T>(a.h, i), T(a.kfac), a.dim);
  }
  template <class Src>
  __device__ void pair(const GsphArgs&, const Src& S, const Pair<T>& q) {
    const Rec<T> vm = S.template rec<T>(kVelM, q.k);     // u v w m
    const Rec<T> th = S.template rec<T>(kThermo, q.k);   // rho p cs e
    const T gi = at.grad(q);
    const T dwi[3] = {gi * q.xij, gi * q.yij, gi * q.zij};
    const T rj1 = T(1) / th.a;
    const T diff[4] = {th.b - pi, vm.a - ui, vm.b - vi, vm.c - wi};
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const T tmp = rj1 * vm.d * diff[f];
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[3 * f + c] += tmp * dwi[c];
    }
  }
  __device__ void store(const GsphArgs& a, int i, bool wm) {
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const T pre = ld<T>(a.pre[oPx + k], i);
      static_cast<T*>(a.out[oPx + k])[i] = wm ? pre + acc[k] : pre;
    }
  }
};

// min(2|x1|, |x2|, 2|x3|) with the three's common sign, 0 where their signs
// differ (gsph.py monotonicity_min)
template <typename T>
__device__ __forceinline__ T monotonicity_min(T x1, T x2, T x3) {
  const T a1 = T(2) * fabs(x1);
  const T a2 = fabs(x2);
  const T a3 = T(2) * fabs(x3);
  const T s1 = sgn(x1), s2 = sgn(x2), s3 = sgn(x3);
  const T m = riemann::tmin(riemann::tmin(a1, a2), a3);
  return (s1 == s2 && s2 == s3) ? s1 * m : T(0);
}

// GSPHAcceleration's loop.
template <typename T, int KIND>
struct Acceleration {
  static constexpr int kBlocks =
      sizeof(T) == 4 ? GSPH_ACC_BLOCKS_F32 : GSPH_ACC_BLOCKS_F64;
  static constexpr bool kConsumes = true;
  T ui = 0, vi = 0, wi = 0, hi = 0, rhoi = 0, pi = 0, csi = 0, ei = 0,
    divi = 0, gxi = 0, gyi = 0, gzi = 0, Hi = 0, dt = 0, bf = 0, kfac = 0;
  T gi9[12] = {};  // the dest's px py pz ux uy uz vx vy vz wx wy wz
  AtH<T, KIND> at{};
  T au = 0, av = 0, aw = 0, ae = 0;
  __device__ void load(const GsphArgs& a, int i) {
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    hi = ld<T>(a.h, i);
    rhoi = ld<T>(a.rho, i);
    pi = ld<T>(a.p, i);
    csi = ld<T>(a.cs, i);
    ei = ld<T>(a.e, i);
    divi = ld<T>(a.div, i);
    gxi = ld<T>(a.grhox, i);
    gyi = ld<T>(a.grhoy, i);
    gzi = ld<T>(a.grhoz, i);
    const void* g[12] = {a.px, a.py, a.pz, a.ux, a.uy, a.uz,
                         a.vx, a.vy, a.vz, a.wx, a.wy, a.wz};
#pragma unroll
    for (int k = 0; k < 12; ++k) gi9[k] = ld<T>(g[k], i);
    kfac = T(a.kfac);
    at.set(hi, kfac, a.dim);
    // the step's dt and t: the card's where given (a CUDA graph replays
    // the step's own), else the host's; the blend in double, as the
    // plain version's exp of a float or a float64 tensor
    const double t = a.t_at != nullptr ? *a.t_at : a.t;
    dt = T(a.dt_at != nullptr ? *a.dt_at : a.dt);
    bf = T(exp(-a.blend_alpha * t / a.tf));
    Hi = T(a.g1) * hi * csi + T(a.g2) * hi * hi * (fabs(divi) - divi);
  }

  // the specific-volume integrals of each side and the interface position
  __device__ __forceinline__ void interpolate(const GsphArgs& a, T hj,
                                              T rhoj, T sij, T gri, T grj,
                                              T& vij_i2, T& vij_j2,
                                              T& sstar) const {
    const T Vi = T(1) / rhoi;
    const T Vj = T(1) / rhoj;
    const T Vip = -gri / (rhoi * rhoi);
    const T Vjp = -grj / (rhoj * rhoj);
    const T hij = T(0.5) * (hi + hj);
    sstar = T(0) + T(0);
    const bool tiny = sij < T(1e-8);
    const T s_safe = tiny ? T(1) : sij;
    if (a.interpolation == 0) {
      vij_i2 = T(1) / (rhoi * rhoi);
      vij_j2 = T(1) / (rhoj * rhoj);
    } else if (a.interpolation == 1) {
      const T cij = tiny ? T(0) : (Vi - Vj) / s_safe;
      const T dij = T(0.5) * (Vi + Vj);
      vij_i2 = T(0.25) * hi * hi * cij * cij + dij * dij;
      vij_j2 = T(0.25) * hj * hj * cij * cij + dij * dij;
      if (!a.interface_zero) {
        const T vij = T(0.5) * (vij_i2 + vij_j2);
        sstar = T(0.5) * hij * hij * cij * dij / vij;
      }
    } else {
      const T aij = tiny ? T(0)
                         : T(-2) * (Vi - Vj) / (s_safe * s_safe * s_safe) +
                               (Vip + Vjp) / (s_safe * s_safe);
      const T bij = tiny ? T(0) : T(0.5) * (Vip - Vjp) / s_safe;
      const T cij = tiny ? T(0)
                         : T(1.5) * (Vi - Vj) / s_safe - T(0.25) * (Vip + Vjp);
      const T dij = tiny ? T(0.5) * (Vi + Vj)
                         : T(0.5) * (Vi + Vj) - T(0.125) * (Vip - Vjp) * sij;
      const T hi2 = hi * hi, hj2 = hj * hj;
      const T hi4 = hi2 * hi2, hj4 = hj2 * hj2;
      const T hi6 = hi4 * hi2, hj6 = hj4 * hj2;
      vij_i2 = (T(15.0 / 64.0) * hi6 * aij * aij +
                T(3.0 / 16.0) * hi4 * (T(2) * aij * cij + bij * bij) +
                T(0.25) * hi2 * (T(2) * bij * dij + cij * cij) + dij * dij);
      vij_j2 = (T(15.0 / 64.0) * hj6 * aij * aij +
                T(3.0 / 16.0) * hj4 * (T(2) * aij * cij + bij * bij) +
                T(0.25) * hj2 * (T(2) * bij * dij + cij * cij) + dij * dij);
      const T hij2 = hij * hij;
      const T hij4 = hij2 * hij2;
      if (!a.interface_zero) {
        const T vij = T(0.5) * (vij_i2 + vij_j2);
        sstar = ((T(15.0 / 32.0)) * hij4 * hij2 * aij * bij +
                 (T(3.0 / 8.0)) * hij4 * (aij * dij + bij * cij) +
                 T(0.5) * hij2 * cij * dij) /
                vij;
      }
    }
  }

  // the source's records are read where each is used, so that a value is
  // held only while it is in use
  template <class Src>
  __device__ void pair(const GsphArgs& a, const Src& S, const Pair<T>& q) {
    const Rec<T> vm = S.template rec<T>(kVelM, q.k);     // u v w m
    const Rec<T> th = S.template rec<T>(kThermo, q.k);   // rho p cs e
    const T hj = q.hj, RIJ = q.rij;
    const T mj = vm.d, rhoj = th.a, pj = th.b, csj = th.c;
    const T hij = T(0.5) * (hi + hj);
    const T eps = T(0.01) * hij * hij;
    const T rhoij = T(0.5) * (rhoi + rhoj);

    const bool near = RIJ < T(1e-14);
    const T rinv = T(1) / (near ? T(1) : RIJ);
    const T e0 = near ? T(0) : q.xij * rinv;
    const T e1 = near ? T(0) : q.yij * rinv;
    const T e2 = near ? T(0) : q.zij * rinv;
    const T sij = near ? T(1) / (RIJ + eps) : rinv;

    // velocities in the local coordinate system (j left, i right)
    const T vl = vm.a * e0 + vm.b * e1 + vm.c * e2;
    const T vr = ui * e0 + vi * e1 + wi * e2;

    const Rec<T> dg = S.template rec<T>(kDivGrho, q.k);  // div grho xyz
    const T grhoi = gxi * e0 + gyi * e1 + gzi * e2;
    const T grhoj = dg.b * e0 + dg.c * e1 + dg.d * e2;
    T vij_i, vij_j, sstar;
    interpolate(a, hj, rhoj, RIJ, grhoi, grhoj, vij_i, vij_j, sstar);

    // directional derivatives of the linear reconstruction
    T rsi = grhoi;
    T psi = gi9[0] * e0 + gi9[1] * e1 + gi9[2] * e2;
    T vsi = (e0 * e0 * gi9[3] + e0 * e1 * (gi9[4] + gi9[6]) +
             e0 * e2 * (gi9[5] + gi9[9]) + e1 * e1 * gi9[7] +
             e1 * e2 * (gi9[8] + gi9[10]) + e2 * e2 * gi9[11]);
    T rsj = grhoj;
    const Rec<T> g4 = S.template rec<T>(kGrad4, q.k);    // px py pz ux
    const Rec<T> g5 = S.template rec<T>(kGrad5, q.k);    // uy uz vx vy
    const Rec<T> g6 = S.template rec<T>(kGrad6, q.k);    // vz wx wy wz
    T psj = g4.a * e0 + g4.b * e1 + g4.c * e2;
    // source: ux g4.d, uy g5.a, uz g5.b, vx g5.c, vy g5.d, vz g6.a,
    // wx g6.b, wy g6.c, wz g6.d
    T vsj = (e0 * e0 * g4.d + e0 * e1 * (g5.a + g5.c) +
             e0 * e2 * (g5.b + g6.b) + e1 * e1 * g5.d +
             e1 * e2 * (g6.a + g6.c) + e2 * e2 * g6.d);

    if (a.monotonicity == 0) {  // first order
      rsi = rsj = psi = psj = vsi = vsj = T(0);
    } else if (a.monotonicity == 1) {  // I02
      if ((vsi * vsj) < T(0)) vsi = vsj = T(0);
      if (riemann::tmin(csi, csj) < T(3) * (vl - vr))
        rsi = rsj = psi = psj = vsi = vsj = T(0);
    } else {  // IwIn
      const T qijr = rhoi - rhoj;
      const T qijp = pi - pj;
      const T qiju = vr - vl;
      auto iwin = [&](T qs, T qv) {
        const T dl = qs * RIJ;
        const T dlp = T(2) * dl - qv;
        return monotonicity_min(qv, dl, dlp) * rinv;
      };
      const T rsi_m = iwin(rsi, qijr), psi_m = iwin(psi, qijp),
              vsi_m = iwin(vsi, qiju), rsj_m = iwin(rsj, qijr),
              psj_m = iwin(psj, qijp), vsj_m = iwin(vsj, qiju);
      rsi = near ? T(0) : rsi_m;
      psi = near ? T(0) : psi_m;
      vsi = near ? T(0) : vsi_m;
      rsj = near ? T(0) : rsj_m;
      psj = near ? T(0) : psj_m;
      vsj = near ? T(0) : vsj_m;
    }

    // MUSCL-style reconstruction of the left and right states
    sstar = sstar * T(2);
    const T fl = T(1) - csj * dt * sij + sstar;
    const T fr = T(1) - csi * dt * sij + sstar;
    T rhol = rhoj + T(0.5) * rsj * RIJ * fl;
    T rhor = rhoi - T(0.5) * rsi * RIJ * fr;
    rhol = rhol < T(0) ? rhoj : rhol;
    rhor = rhor < T(0) ? rhoi : rhor;
    T pl = pj + T(0.5) * psj * RIJ * fl;
    T pr = pi - T(0.5) * psi * RIJ * fr;
    pl = pl < T(0) ? pj : pl;
    pr = pr < T(0) ? pi : pr;
    const T ul = vl + T(0.5) * vsj * RIJ * fl;
    const T ur = vr - T(0.5) * vsi * RIJ * fr;

    T pstar, ustar;
    riemann::solve(a.rsolver, rhol, rhor, pl, pr, ul, ur, a.gamma, a.niter,
                   pstar, ustar);
    if (a.hybrid) {
      T pstar2, ustar2;
      riemann::hllsy(rhoj, rhoi, pl, pr, vl, vr, a.gamma, pstar2, ustar2);
      ustar = ustar + bf * (ustar2 - ustar);
      pstar = pstar + bf * (pstar2 - pstar);
    }
    const T v0 = ustar * e0, v1 = ustar * e1, v2 = ustar * e2;

    // DWI, DWJ and DWIJ: the gradient at the dest's, the source's and
    // their mean smoothing length
    AtH<T, KIND> atj, atij;
    atj.set(hj, kfac, a.dim);
    atij.set(hij, kfac, a.dim);
    const T gi = at.grad(q), gj = atj.grad(q);
    const T dwi[3] = {gi * q.xij, gi * q.yij, gi * q.zij};
    const T dwj[3] = {gj * q.xij, gj * q.yij, gj * q.zij};
    au += -mj * pstar * (vij_i * dwi[0] + vij_j * dwj[0]);
    av += -mj * pstar * (vij_i * dwi[1] + vij_j * dwj[1]);
    aw += -mj * pstar * (vij_i * dwi[2] + vij_j * dwj[2]);
    const T vstardotdwi = v0 * dwi[0] + v1 * dwi[1] + v2 * dwi[2];
    const T vstardotdwj = v0 * dwj[0] + v1 * dwj[1] + v2 * dwj[2];
    ae += -mj * pstar * (vij_i * vstardotdwi + vij_j * vstardotdwj);

    if (a.conduction) {
      const T gij = atij.grad(q);
      const T divj = dg.a;
      const T Hj = T(a.g1) * hj * csj +
                   T(a.g2) * hj * hj * (fabs(divj) - divj);
      T Hij = (Hi + Hj) * (ei - th.d);
      Hij = Hij / (rhoij * (RIJ * RIJ + eps));
      ae += mj * Hij * (q.xij * (gij * q.xij) + q.yij * (gij * q.yij) +
                        q.zij * (gij * q.zij));
    }
  }
  __device__ void store(const GsphArgs& a, int i, bool wm) {
    const T acc[4] = {au, av, aw, ae};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T pre = ld<T>(a.pre[oAu + k], i);
      static_cast<T*>(a.out[oAu + k])[i] = wm ? pre + acc[k] : pre;
    }
  }
};

constexpr int kThreads = 128;
// listed entries whose loads a lane has in flight
constexpr int kListBatch = 4;

template <typename T, int KIND, bool PERIODIC, class PhaseSet>
__global__ void __launch_bounds__(kThreads, PhaseSet::kBlocks)
    gsph_pair_kernel(const __grid_constant__ GsphArgs a) {
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
  const T rs = T(a.radius_scale);
  const walk::Box<T> box{{T(a.box[0]), T(a.box[1]), T(a.box[2])}};
  int pairs = 0;
  bool walking = true;
  if (PhaseSet::kConsumes && a.mode == kConsume) {
    const int count = active ? a.lcount[pos] : 0;
    walking = __any_sync(walk::kFull, count > a.cap);
    // the list runs source by source: s is the source of the entries
    int s = 0;
    for (int c0 = 0; !walking && c0 < count; c0 += kListBatch) {
      int e[kListBatch];
#pragma unroll
      for (int u = 0; u < kListBatch; ++u)
        e[u] = c0 + u < count ? a.nbr[size_t(c0 + u) * a.n_dest + pos] : -1;
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (e[u] < 0) continue;
        while (s + 1 < a.n_src && e[u] >= a.src[s + 1].base) ++s;
        const int k = e[u] - a.src[s].base;
        const CopyPlanes P{a.src[s].plane};
        ++pairs;
        ph.pair(a, P,
                pair_of<T, PERIODIC>(di, P.template rec<T>(kPos, k), k, box));
      }
    }
  }
  if (walking) {
    const bool emit = a.mode == kEmit;
    int listed = 0;
    const walk::Lane l = walk::lane_cell(a, active ? a.cell[i] : 0, active);
    walk::Walker<T> walker;
    walker.begin();
    for (int s = 0; s < a.n_src; ++s) {
      const GsphSrc& S = a.src[s];
      const void* p0 = S.plane[kPos];
      const CopyPlanes P{S.plane};
      auto body = [&](int k) {
        if (emit) {
          if (listed < a.cap) a.nbr[size_t(listed) * a.n_dest + pos] = S.base + k;
          ++listed;
        }
        ++pairs;
        ph.pair(a, P, pair_of<T, PERIODIC>(di, rec<T>(p0, k), k, box));
      };
      if (PERIODIC)
        walk::walk_rows_periodic(a, S.cell_start, S.cell_end, p0, l, di, rs,
                                 box, walker, body);
      else
        walk::walk_rows(a, S.cell_start, S.cell_end, p0, l, 1, di, rs, walker,
                        body);
      walker.finish(body);
    }
    if (emit && active) {
      a.lcount[pos] = listed;
      if (listed > a.cap) atomicAdd(a.overflow, 1);
    }
  }
  if (active) {
    ph.store(a, i, a.wmask == nullptr || a.wmask[i] != 0);
    if (a.count != nullptr) a.count[i] = pairs;
  }
}

template <typename T, int KIND, bool PERIODIC>
cudaError_t launch_walk(const GsphArgs& a, cudaStream_t stream) {
  const int blocks = (a.n_dest + kThreads - 1) / kThreads;
  if (a.phase == kGradients)
    gsph_pair_kernel<T, KIND, PERIODIC, Gradients<T, KIND>>
        <<<blocks, kThreads, 0, stream>>>(a);
  else
    gsph_pair_kernel<T, KIND, PERIODIC, Acceleration<T, KIND>>
        <<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_kind(const GsphArgs& a, cudaStream_t stream) {
  return a.periodic ? launch_walk<T, KIND, true>(a, stream)
                    : launch_walk<T, KIND, false>(a, stream);
}

template <typename T>
cudaError_t launch(const GsphArgs& a, cudaStream_t stream) {
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    return launch_kind<T, decltype(kind)::value>(a, stream);
  });
}

// the planes each set reads (ops/gsph_pair.py pack_layout)
int planes_of(int phase) { return phase == kGradients ? 3 : kGsphPlanes; }

bool args_ok(const GsphArgs& a) {
  const int set_terms = a.phase == kGradients ? kGrad : kAcc;
  bool sources_ok = a.n_src >= 1 && a.n_src <= kGsphSources;
  for (int s = 0; sources_ok && s < a.n_src; ++s) {
    const GsphSrc& S = a.src[s];
    sources_ok = S.terms == set_terms && S.cell_start != nullptr &&
                 S.cell_end != nullptr;
    for (int q = 0; q < planes_of(a.phase); ++q)
      sources_ok = sources_ok && S.plane[q] != nullptr;
  }
  const int first = a.phase == kGradients ? oPx : oAu;
  const int last = a.phase == kGradients ? oWz : oAe;
  bool outs_ok = true;
  for (int k = first; k <= last; ++k)
    outs_ok = outs_ok && a.pre[k] != nullptr && a.out[k] != nullptr;
  const bool branches_ok =
      a.rsolver >= 0 && a.rsolver <= 10 && a.niter >= 0 &&
      a.monotonicity >= 0 && a.monotonicity <= 2 && a.interpolation >= 0 &&
      a.interpolation <= 2 && a.tf != 0.0;
  const bool mode_ok =
      a.mode == kWalk ||
      (a.cap >= 1 && a.nbr != nullptr && a.lcount != nullptr &&
       (a.mode == kEmit ? a.phase == kGradients && a.overflow != nullptr
                        : a.mode == kConsume && a.phase == kAcceleration));
  return sources_ok && outs_ok && branches_ok && mode_ok && a.nx >= 1 &&
         a.ny >= 1 && a.nz >= 1 && a.dim >= 1 && a.dim <= 3 &&
         (a.dtype == 0 || a.dtype == 1) &&
         shapes::built_kind(a.kernel_kind) &&
         (a.phase == kGradients || a.phase == kAcceleration) &&
         a.dorder != nullptr && a.cell != nullptr &&
         pack::args_ok(a.pack) && a.pack.dtype == a.dtype;
}

template <typename T>
__global__ void __launch_bounds__(128)
    riemann_kernel(const RiemannArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  T ps, us;
  riemann::solve(a.method, ld<T>(a.rhol, i), ld<T>(a.rhor, i),
                 ld<T>(a.pl, i), ld<T>(a.pr, i), ld<T>(a.ul, i),
                 ld<T>(a.ur, i), a.gamma, a.niter, ps, us);
  static_cast<T*>(a.pstar)[i] = ps;
  static_cast<T*>(a.ustar)[i] = us;
}

}  // namespace

extern "C" {

int gsph_pair_args_size() { return static_cast<int>(sizeof(GsphArgs)); }

int gsph_pair_launch(const GsphArgs* args, void* stream) {
  const GsphArgs& a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                       : launch<double>(a, st));
}

int gsph_pair_riemann(const RiemannArgs* args, void* stream) {
  const RiemannArgs& a = *args;
  if (a.n < 0 || a.method < 0 || a.method > 10 || a.niter < 0 ||
      (a.dtype != 0 && a.dtype != 1) || a.rhol == nullptr ||
      a.rhor == nullptr || a.pl == nullptr || a.pr == nullptr ||
      a.ul == nullptr || a.ur == nullptr || a.pstar == nullptr ||
      a.ustar == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (a.n + 127) / 128;
  if (a.dtype == 0)
    riemann_kernel<float><<<blocks, 128, 0, st>>>(a);
  else
    riemann_kernel<double><<<blocks, 128, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* gsph_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
