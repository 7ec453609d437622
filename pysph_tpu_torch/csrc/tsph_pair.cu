// TSPH's pair kernel for Hopper (sm_90a): TSPHScheme's number-density
// sweep, C1 velocity gradient and grad-h momentum with per-particle
// smoothing lengths, over the warp-coherent walk of csrc/cell_walk.cuh and
// the cell-sorted packed sources of csrc/cell_pack.cuh, on an open or a
// periodic grid.
//
// Replaces pysph_tpu/ops/pallas_engine.py::_pair_kernel_compact (:1160,
// its pallas_call :1867), which the TPU runs for every pair phase of
// TSPHScheme (the resident engine turns itself off for an update_nnps
// group).  Three phase sets, one device functor each:
//
//   Density    SummationDensity: WI, DWI and GHI at the dest's h; VIJ.DWI
//              times fij = 1 - inprthsi / (mj inbrkti) from the dest's
//              prevn prevdndh prevdrhosumdh
//              -> rho arho drhosumdh n an dndh
//   Gradient   VelocityGradDivC1: -mj XIJ x DWI into invtt, -mj VIJ x DWI
//              into gradv (the DIM x DIM block of the row-major 3 x 3,
//              stride 9), DWI at the dest's h -> invtt gradv
//   Momentum   MomentumAndEnergy: DWI at the dest's h, DWJ at the
//              source's; Monaghan's viscosity where VIJ.XIJ <= 0 (HIJ,
//              R2IJ, RHOIJ1), the grad-h pressure terms fij and fji
//              -> au av aw ae
//
// h varies per particle: the walk's support test is r2 < (rs max(hi,
// hj))^2 (walk::in_support).  The shape is a template parameter (any kind
// of csrc/shapes.cuh): this library holds the Gaussian (kind 2, the
// scheme's) alone, and each other kind is a library of its own
// (-DPAIR_KIND=k, ops/tsph_pair.py kind_flags); DIM is a template
// parameter too, 1 and 2 in this library and 3 in one of its own
// (-DTSPH_DIM3).  One launch computes the pair terms of one dest array
// over all its sources (at most 4) and writes each output once: pre + sum
// under the write mask, pre elsewhere (invtt and gradv: the DIM x DIM
// columns; the others pre); with a non-null count, each dest's number of
// pairs in support.
//
// Design, as csrc/gasd_pair.cu's walk: thread t takes the dest at
// position t of the dest's sorted order, so a warp holds dests of one or
// a few nearby cells; each lane walks its own cells cx - 1 .. cx + 1 in
// each stencil row (on a periodic grid, the template flag PERIODIC, the
// rows wrap and each displacement is the minimum image,
// walk::walk_rows_periodic); the walker hands the candidates in support
// to the pair body in rounds, one per lane.  Each source is read from its
// packed copy (launched by this file's launch function just before the
// kernel), whose record planes are, as ops/tsph_pair.py PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: u v w m
//   plane 2: rho p cs alpha
//   plane 3: n dndh drhosumdh 0
// of which the density and gradient sets pack planes 0 and 1, the
// momentum set all four.  The momentum launch then rewrites each source's
// plane 3 as pj / rhoj^2, inprthsj, inbrktj, 0 (tsph_terms_kernel; the
// terms of the source alone, once a source instead of once a pair), and
// the dest's own terms are taken once a dest.  No shared memory: every
// run sums in the order of the plain stencil walk.  Built with -fmad=false
// (ops/build.py EXTRA_FLAGS): the support test and the sweep's Newton step
// round each operation as the plain version's, so that the pairs, each
// dest's count and the converged flags are the plain version's.
//
// Modes (the template flag MODE).  kWalk: the call above.  kSweep, the
// density set only: one sweep of TSPHScheme's iterated density group
// (ops/tsph_pair.py tsph_sweep), all gated by the 0-d flag run (null:
// runs; where 0 the pack and the kernel return at once and nothing is
// written): the pack, SummationDensity's initialize (the prev* copies of
// n dndh drhosumdh, the sums at 0 under the write mask), its pair sums,
// its post_loop (the Newton step of h towards n = (hfact / h)^DIM of each
// particle not yet converged, clipped to [0.8 h, 1.2 h], ah where done,
// converged; in the IEEE operations of the torch post_loop, hfact / h
// taken as torch takes a number over a tensor, (1 / h) hfact) written in
// place of the dest's props (each dest reads its own props before it
// writes them: the walk reads the sources from the packed snapshot), and
// the count of the particles not converged after it (warp-aggregated
// atomics, an integer: deterministic); and it emits its neighbour list:
// entry c of the dest at sorted position p is nbr[c * n_dest + p], source
// s's position k numbered base_s + k, for c < cap, lcount[p] its pairs
// (each dest past cap adds one to *overflow).  kConsume, the gradient and
// momentum sets: where the 0-d flag use is set (the iteration ended
// converged, decided on the card) the pack skips plane 0 and the kernel
// reads {x y z h} from the last sweep's copy (hplane) and a warp whose
// dests all fit reads their listed pairs in list order, handing each to
// the same pair_of and functor as the walk, so its sums are the walk's
// bit for bit; a warp with a dest past cap walks (on that copy).  Where
// use is 0 it packs all four planes and walks, as kWalk.
//
// What bounds it: operations.  A launch tests the candidates of the
// stencil (a 16-byte record load and a support test each); per pair in
// support the density set evaluates the kernel's shape once (an exp for
// the Gaussian) and ~30 flops on two records, the gradient set the shape
// once and ~4 DIM^2 + 20 flops on two records, the momentum set the shape
// at two smoothing lengths and ~70 flops on four records.
//
// Interface: plain C, called through ctypes (ops/tsph_pair.py).  The
// launch function takes a host pointer to TsphArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack, the
// momentum set's per-source terms, then the kernel, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PAIR_KIND
#define PAIR_KIND 2
#endif

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "shapes.cuh"

constexpr int kTsphSources = 4;
// term bits, as ops/tsph_pair.py SDEN, GRADV, MOM
constexpr int kSden = 1, kGradv = 2, kMom = 4;
// outputs in the order of ops/tsph_pair.py OUTPUTS
enum TsphOut {
  oRho, oArho, oDrhosumdh, oN, oAn, oDndh, oInvtt, oGradv, oAu, oAv, oAw,
  oAe, kTsphOut
};
// phase ids: the index of the phase set in ops/tsph_pair.py PHASE_SETS
enum TsphPhase { kDensity, kGradient, kMomentum };
// modes, as ops/tsph_pair.py WALK, SWEEP, CONSUME
enum TsphMode { kWalk, kSweep, kConsume };
// kSweep's outputs, the order of ops/tsph_pair.py SWEEP_OUTPUTS: the sums,
// initialize's copies, then post_loop's
enum TsphSweep {
  wRho, wArho, wDrhosumdh, wN, wAn, wDndh, wPrevn, wPrevdndh,
  wPrevdrhosumdh, wH, wAh, wConverged, kSweepOut
};
// kConsume: listed entries whose loads a lane has in flight
constexpr int kListBatch = 4;
// the record planes of a packed copy
enum TsphPlane { kPos, kVelM, kThermo, kGradH, kTsphPlanes };

// The argument structs are at global scope: the exported C functions take
// them, and a type in an unnamed namespace would give those functions
// internal linkage.
struct TsphSrc {
  // the packed copy's planes, in the source's cell order; null where the
  // set reads none of the plane's props
  void* plane[kTsphPlanes];
  const int32_t* cell_start;  // per cell: first position in the copy
  const int32_t* cell_end;    // per cell: one past the last
  int32_t terms;
  int32_t base;  // its position 0 in the neighbour list's numbering
};

struct TsphArgs {
  const void *x, *y, *z, *h, *u, *v, *w, *m, *rho, *p, *cs, *alpha, *n,
      *dndh, *drhosumdh, *prevn, *prevdndh, *prevdrhosumdh;  // dest
  const int32_t* cell;         // dest cell id, ix + nx * (iy + ny * iz)
  const int32_t* dorder;       // the dest's cell order: threads follow it
  const uint8_t* wmask;        // write mask (bool); null: every row
  const void* pre[kTsphOut];   // values before the phase; null: unused
  void* out[kTsphOut];
  int32_t* count;              // non-null: each dest's pairs in support
  TsphSrc src[kTsphSources];
  double radius_scale, kfac;   // kfac: the kernel's sigma
  double box[3];  // the length of each periodic axis, 0 on the others
  double beta, fkern;          // MomentumAndEnergy's
  double hfact, htol;          // kSweep: SummationDensity's
  int32_t n_dest, n_src, nx, ny, nz, dim, phase, dtype, kernel_kind,
      periodic, mode, cap, iterate_once, density_iterations;
  const uint8_t* run;          // kSweep: null or the gate
  const uint8_t* use;          // kConsume: read the list where *use != 0
  const void* h0;              // kSweep: dest
  const void* swpre[kSweepOut];  // kSweep: the values before, TsphSweep
  void* sw[kSweepOut];         // order, and the outputs (in place: the
                               // same pointers)
  int32_t* unconv;             // kSweep: += the particles not converged
  int32_t* nbr;                // (cap, n_dest)
  int32_t* lcount;             // (n_dest): pairs by sorted position
  int32_t* overflow;           // kSweep: += dests with more than cap
  const void* hplane[kTsphSources];  // kConsume: the last sweep's plane 0
  // the pack that fills the sources' planes: the launch function launches
  // it just before the kernel
  PackArgs pack;
};

namespace {

using walk::Rec;
using walk::rec;

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

template <int DIM, typename T>
__device__ __forceinline__ T hpow(T h1) {
  return DIM == 1 ? h1 : DIM == 2 ? h1 * h1 : h1 * h1 * h1;
}

// torch.maximum / torch.minimum: a NaN of either side propagates
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// One pair in support: k, the source particle's position in its packed
// copy; XIJ (the minimum image on a periodic grid), R2IJ, RIJ, 1 / RIJ (0
// at RIJ = 0, as the torch pair engine's RINV) and the source's h.
template <typename T>
struct Pair {
  int k;
  T xij, yij, zij, r2, rij, rinv, hj;
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
  q.r2 = q.xij * q.xij + q.yij * q.yij + q.zij * q.zij;
  q.rinv = q.r2 > T(1e-24) ? T(1) / sqrt(q.r2) : T(0);
  q.rij = q.r2 * q.rinv;
  q.hj = pj.d;
  return q;
}

// The kernel of shape KIND at one smoothing length h: h1 = 1 / h (1 where
// h <= 0), fac = sigma h1^DIM, as the torch pair engine's _kparts.
template <typename T, int KIND, int DIM>
struct AtH {
  T h1, fac;
  __device__ __forceinline__ void set(T h, T kfac) {
    h1 = T(1) / (h > T(0) ? h : T(1));
    fac = kfac * hpow<DIM>(h1);
  }
  // the gradient's factor: DW = grad(q) * XIJ (0 where RIJ <= 1e-12)
  __device__ __forceinline__ T grad(const Pair<T>& q) const {
    T w, dw;
    shapes::shape<T, KIND>(q.rij * h1, w, dw);
    return q.rij > T(1e-12) ? dw * fac * h1 * q.rinv : T(0);
  }
};

// SummationDensity's sums, and in kSweep its initialize and post_loop.
template <typename T, int KIND, int DIM>
struct Density {
  static constexpr int kPhase = kDensity;
  T ui = 0, vi = 0, wi = 0, inbrkti = 0, inprthsi = 0;
  AtH<T, KIND, DIM> at{};
  T rho = 0, arho = 0, drhosumdh = 0, n = 0, an = 0, dndh = 0;
  // prevn, prevdndh, prevdrhosumdh: the props of those names (kWalk), or
  // the dest's n, dndh, drhosumdh before the sweep (kSweep: initialize
  // copies them)
  __device__ void load(const TsphArgs& a, int i, bool sweep) {
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    const T hi = ld<T>(a.h, i);
    const T prevn = ld<T>(sweep ? a.swpre[wN] : a.prevn, i);
    const T prevdndh = ld<T>(sweep ? a.swpre[wDndh] : a.prevdndh, i);
    const T prevdrho =
        ld<T>(sweep ? a.swpre[wDrhosumdh] : a.prevdrhosumdh, i);
    const T hibynidim = hi / (prevn * T(DIM));
    inbrkti = T(1) + prevdndh * hibynidim;
    inprthsi = prevdrho * hibynidim;
    at.set(hi, T(a.kfac));
  }
  __device__ void pair(const TsphSrc& S, const Pair<T>& q) {
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);  // u v w m
    const T qi = q.rij * at.h1;
    T w, dw;
    shapes::shape<T, KIND>(qi, w, dw);
    const T wij = w * at.fac;
    const T gr = q.rij > T(1e-12) ? dw * at.fac * at.h1 * q.rinv : T(0);
    const T mj = vm.d;
    const T vdot = (ui - vm.a) * (gr * q.xij) + (vi - vm.b) * (gr * q.yij) +
                   (wi - vm.c) * (gr * q.zij);
    const T ghi = shapes::gradient_h(w, dw, qi, at.fac, at.h1, DIM);
    rho += mj * wij;
    const T fij = T(1) - inprthsi / (mj * inbrkti);
    const T vf = vdot * fij;
    arho += mj * vf;
    an += vf;
    drhosumdh += mj * ghi;
    n += wij;
    dndh += ghi;
  }
  __device__ void store(const TsphArgs& a, int i, bool wm) {
    const T acc[6] = {rho, arho, drhosumdh, n, an, dndh};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const T pre = ld<T>(a.pre[oRho + k], i);
      static_cast<T*>(a.out[oRho + k])[i] = wm ? pre + acc[k] : pre;
    }
  }
  // kSweep: initialize, the sums and post_loop of SummationDensity, in
  // place of the dest's props (hi: its h, read before the walk); returns
  // whether the particle is converged after it
  __device__ bool sweep(const TsphArgs& a, int i, bool wm, T hi) {
    T v[kSweepOut];
#pragma unroll
    for (int k = 0; k < kSweepOut; ++k) v[k] = ld<T>(a.swpre[k], i);
    if (wm) {
      // initialize copies n dndh drhosumdh and zeroes the sums, the pair
      // phase adds
      v[wPrevn] = v[wN];
      v[wPrevdndh] = v[wDndh];
      v[wPrevdrhosumdh] = v[wDrhosumdh];
      v[wRho] = T(0) + rho;
      v[wArho] = T(0) + arho;
      v[wDrhosumdh] = T(0) + drhosumdh;
      v[wN] = T(0) + n;
      v[wAn] = T(0) + an;
      v[wDndh] = T(0) + dndh;
      if (a.density_iterations) post_loop(a, i, hi, v);
    }
#pragma unroll
    for (int k = 0; k < kSweepOut; ++k) static_cast<T*>(a.sw[k])[i] = v[k];
    return v[wConverged] == T(1);
  }
  // SummationDensity.post_loop with density_iterations, as its torch ops
  __device__ void post_loop(const TsphArgs& a, int i, T hi, T* v) {
    const bool act = v[wConverged] != T(1);
    const T hi0 = ld<T>(a.h0, i);
    const T ni = hpow<DIM>((T(1) / hi) * T(a.hfact));
    const T dndhi = (T(-DIM) * v[wN]) / hi;
    const T func = v[wN] - ni;
    T dfdh = v[wDndh] - dndhi;
    dfdh = dfdh != T(0) ? dfdh : T(1);
    const T hnew = tmin(tmax(hi - func / dfdh, T(0.8) * hi), T(1.2) * hi);
    const T diff = fabs(hnew - hi) / hi0;
    const bool done = a.iterate_once != 0 || diff < T(a.htol);
    v[wH] = act && !done ? hnew : hi;
    if (act && done) v[wAh] = v[wAn] / dndhi;
    v[wConverged] = act && done ? T(1) : act ? T(0) : v[wConverged];
  }
};

// VelocityGradDivC1's sums.
template <typename T, int KIND, int DIM>
struct Gradient {
  static constexpr int kPhase = kGradient;
  T ui = 0, vi = 0, wi = 0;
  AtH<T, KIND, DIM> at{};
  T tt[DIM * DIM] = {}, gv[DIM * DIM] = {};
  __device__ void load(const TsphArgs& a, int i, bool) {
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    at.set(ld<T>(a.h, i), T(a.kfac));
  }
  __device__ void pair(const TsphSrc& S, const Pair<T>& q) {
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);  // u v w m
    const T gr = at.grad(q);
    const T x[3] = {q.xij, q.yij, q.zij};
    const T vij[3] = {ui - vm.a, vi - vm.b, wi - vm.c};
    const T mj = -vm.d;
#pragma unroll
    for (int r = 0; r < DIM; ++r) {
#pragma unroll
      for (int c = 0; c < DIM; ++c) {
        const T dwc = gr * x[c];
        tt[r * DIM + c] += mj * x[r] * dwc;
        gv[r * DIM + c] += mj * vij[r] * dwc;
      }
    }
  }
  __device__ void store(const TsphArgs& a, int i, bool wm) {
    const T* pt = static_cast<const T*>(a.pre[oInvtt]) + 9 * size_t(i);
    const T* pg = static_cast<const T*>(a.pre[oGradv]) + 9 * size_t(i);
    T* ot = static_cast<T*>(a.out[oInvtt]) + 9 * size_t(i);
    T* og = static_cast<T*>(a.out[oGradv]) + 9 * size_t(i);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int r = k / 3, c = k % 3;
      const bool in = wm && r < DIM && c < DIM;
      ot[k] = in ? pt[k] + tt[r * DIM + c] : pt[k];
      og[k] = in ? pg[k] + gv[r * DIM + c] : pg[k];
    }
  }
};

// MomentumAndEnergy's loop.
template <typename T, int KIND, int DIM>
struct Momentum {
  static constexpr int kPhase = kMomentum;
  T ui = 0, vi = 0, wi = 0, hi = 0, mi = 0, rhoi = 0, csi = 0, alphai = 0,
    pibrhoi2 = 0, inbrkti = 0, inprthsi = 0, kfac = 0, beta = 0, fkern = 0;
  AtH<T, KIND, DIM> at{};
  T au = 0, av = 0, aw = 0, ae = 0;
  __device__ void load(const TsphArgs& a, int i, bool) {
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    hi = ld<T>(a.h, i);
    mi = ld<T>(a.m, i);
    rhoi = ld<T>(a.rho, i);
    csi = ld<T>(a.cs, i);
    alphai = ld<T>(a.alpha, i);
    pibrhoi2 = ld<T>(a.p, i) / (rhoi * rhoi);
    const T hibynidim = hi / (ld<T>(a.n, i) * T(DIM));
    inbrkti = T(1) + ld<T>(a.dndh, i) * hibynidim;
    inprthsi = ld<T>(a.drhosumdh, i) * hibynidim;
    kfac = T(a.kfac);
    beta = T(a.beta);
    fkern = T(a.fkern);
    at.set(hi, kfac);
  }
  __device__ void pair(const TsphSrc& S, const Pair<T>& q) {
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);    // u v w m
    const Rec<T> th = rec<T>(S.plane[kThermo], q.k);  // rho p cs alpha
    // pj / rhoj^2, inprthsj, inbrktj, 0 (tsph_terms_kernel)
    const Rec<T> gt = rec<T>(S.plane[kGradH], q.k);
    AtH<T, KIND, DIM> atj;
    atj.set(q.hj, kfac);
    const T gi = at.grad(q), gj = atj.grad(q);
    const T dwi[3] = {gi * q.xij, gi * q.yij, gi * q.zij};
    const T dwj[3] = {gj * q.xij, gj * q.yij, gj * q.zij};
    const T vij[3] = {ui - vm.a, vi - vm.b, wi - vm.c};
    const T mj = vm.d;
    const T cij = T(0.5) * (csi + th.c);
    const T hij = fkern * (T(0.5) * (hi + q.hj));
    const T vdotx = vij[0] * q.xij + vij[1] * q.yij + vij[2] * q.zij;
    // artificial viscosity, only approaching pairs
    if (vdotx <= T(0)) {
      const T rhoij = T(0.5) * (rhoi + th.a);
      const T rhoij1 = T(1) / (rhoij != T(0) ? rhoij : T(1));
      const T alpha = T(0.5) * (alphai + th.d);
      const T muij = hij * vdotx / (q.r2 + T(0.0001) * hij * hij);
      const T common =
          alpha * muij * (cij - beta * muij) * mj * rhoij1 / T(2);
      const T avi[3] = {common * (dwi[0] + dwj[0]),
                        common * (dwi[1] + dwj[1]),
                        common * (dwi[2] + dwj[2])};
      au += avi[0];
      av += avi[1];
      aw += avi[2];
      ae -= T(0.5) * (vij[0] * avi[0] + vij[1] * avi[1] + vij[2] * avi[2]);
    }
    // grad-h corrected pressure gradient
    const T fij = T(1) - inprthsi / (mj * inbrkti);
    const T fji = T(1) - gt.b / (mi * gt.c);
    const T comi = mj * pibrhoi2 * fij;
    const T comj = mj * gt.a * fji;
    au -= comi * dwi[0] + comj * dwj[0];
    av -= comi * dwi[1] + comj * dwj[1];
    aw -= comi * dwi[2] + comj * dwj[2];
    ae += comi * (vij[0] * dwi[0] + vij[1] * dwi[1] + vij[2] * dwi[2]);
  }
  __device__ void store(const TsphArgs& a, int i, bool wm) {
    const T acc[4] = {au, av, aw, ae};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T pre = ld<T>(a.pre[oAu + k], i);
      static_cast<T*>(a.out[oAu + k])[i] = wm ? pre + acc[k] : pre;
    }
  }
};

// kSweep's store: the density set's sweep (the other sets never sweep)
template <typename T, int KIND, int DIM>
__device__ __forceinline__ bool sweep_of(Density<T, KIND, DIM>& ph,
                                         const TsphArgs& a, int i, bool wm,
                                         T hi) {
  return ph.sweep(a, i, wm, hi);
}
template <class PhaseSet, typename T>
__device__ __forceinline__ bool sweep_of(PhaseSet&, const TsphArgs&, int,
                                         bool, T) {
  return true;
}

// The blocks of 128 threads an SM that a kernel's __launch_bounds__ asks
// for: double 4; float 8 for the density and gradient sets, 6 for the
// momentum set (as csrc/gasd_pair.cu's).
template <typename T, class PhaseSet>
constexpr int blocks_for() {
  return sizeof(T) == 8 ? 4 : PhaseSet::kPhase == kMomentum ? 6 : 8;
}

template <typename T, bool PERIODIC, class PhaseSet, int MODE>
__global__ void __launch_bounds__(128, (blocks_for<T, PhaseSet>()))
    tsph_pair_kernel(const TsphArgs a) {
  if (MODE == kSweep && a.run != nullptr && *a.run == 0) return;
  // every lane stays to the end: the walk's votes take the whole warp
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pos < a.n_dest;
  const int i = active ? a.dorder[pos] : 0;

  Rec<T> di{};  // {xi, yi, zi, hi}
  PhaseSet ph;
  if (active) {
    di = {ld<T>(a.x, i), ld<T>(a.y, i), ld<T>(a.z, i), ld<T>(a.h, i)};
    ph.load(a, i, MODE == kSweep);
  }
  const T rs = T(a.radius_scale);
  const walk::Box<T> box{{T(a.box[0]), T(a.box[1]), T(a.box[2])}};
  const bool linked = MODE == kConsume && *a.use != 0;
  // each source's {x y z h}: the last sweep's copy where linked
  auto plane0 = [&](int s) {
    return linked ? a.hplane[s] : a.src[s].plane[kPos];
  };
  int pairs = 0;
  bool walking = true;
  if (linked) {
    const int count = active ? a.lcount[pos] : 0;
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
        pj[u] = rec<T>(a.hplane[s], e[u] - a.src[s].base);
      }
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (e[u] < 0) continue;
        const TsphSrc& S = a.src[from[u]];
        ++pairs;
        ph.pair(S, pair_of<T, PERIODIC>(di, pj[u], e[u] - S.base, box));
      }
    }
  }
  if (walking) {
    const walk::Lane l = walk::lane_cell(a, active ? a.cell[i] : 0, active);
    walk::Walker<T> walker;
    walker.begin();
    int listed = 0;
    for (int s = 0; s < a.n_src; ++s) {
      const TsphSrc& S = a.src[s];
      const void* p0 = plane0(s);
      auto body = [&](int k) {
        if (MODE == kSweep) {
          if (listed < a.cap)
            a.nbr[size_t(listed) * a.n_dest + pos] = S.base + k;
          ++listed;
        }
        ++pairs;
        ph.pair(S, pair_of<T, PERIODIC>(di, rec<T>(p0, k), k, box));
      };
      if (PERIODIC)
        walk::walk_rows_periodic(a, S.cell_start, S.cell_end, p0, l, di, rs,
                                 box, walker, body);
      else
        walk::walk_rows(a, S.cell_start, S.cell_end, p0, l, 1, di, rs,
                        walker, body);
      walker.finish(body);
    }
    if (MODE == kSweep && active) {
      a.lcount[pos] = listed;
      if (listed > a.cap) atomicAdd(a.overflow, 1);
    }
  }
  if (MODE == kSweep) {
    bool open = false;
    if (active)
      open = !sweep_of(ph, a, i, a.wmask == nullptr || a.wmask[i] != 0,
                       di.d);
    const unsigned votes = __ballot_sync(walk::kFull, open);
    if ((threadIdx.x & 31) == 0 && votes != 0)
      atomicAdd(a.unconv, __popc(votes));
    return;
  }
  if (active) {
    ph.store(a, i, a.wmask == nullptr || a.wmask[i] != 0);
    if (a.count != nullptr) a.count[i] = pairs;
  }
}

// The momentum launch's per-source terms: each source's packed plane 3,
// n dndh drhosumdh 0, rewritten as pj / rhoj^2, inprthsj = drhosumdhj
// hjbynjdim, inbrktj = 1 + dndhj hjbynjdim, 0 (hjbynjdim = hj / (nj DIM)),
// in MomentumAndEnergy's operations (ops/tsph_pair.py
// mom_terms_reference); hj from the plane 0 that the kernel reads.
template <typename T, int DIM>
__global__ void __launch_bounds__(256) tsph_terms_kernel(const TsphArgs a) {
  const int s = blockIdx.y;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.pack.src[s].n) return;
  const bool linked = a.mode == kConsume && *a.use != 0;
  const Rec<T> pos = rec<T>(linked ? a.hplane[s] : a.src[s].plane[kPos], k);
  const Rec<T> th = rec<T>(a.src[s].plane[kThermo], k);  // rho p cs alpha
  const Rec<T> g = rec<T>(a.src[s].plane[kGradH], k);    // n dndh drho 0
  const T hbyndim = pos.d / (g.a * T(DIM));
  pack::store(static_cast<T*>(a.src[s].plane[kGradH]), k,
              th.b / (th.a * th.a), g.c * hbyndim, T(1) + g.b * hbyndim,
              T(0));
}

constexpr int kThreads = 128;

template <typename T, int KIND, int DIM, bool PERIODIC>
cudaError_t launch_walk(const TsphArgs& a, cudaStream_t stream) {
  using D = Density<T, KIND, DIM>;
  using G = Gradient<T, KIND, DIM>;
  using M = Momentum<T, KIND, DIM>;
  const int blocks = (a.n_dest + kThreads - 1) / kThreads;
  if (a.phase == kMomentum) {
    int n = 0;
    for (int s = 0; s < a.pack.n_src; ++s)
      n = a.pack.src[s].n > n ? a.pack.src[s].n : n;
    if (n > 0)
      tsph_terms_kernel<T, DIM>
          <<<dim3((n + 255) / 256, a.pack.n_src), 256, 0, stream>>>(a);
  }
  if (a.mode == kSweep)
    tsph_pair_kernel<T, PERIODIC, D, kSweep>
        <<<blocks, kThreads, 0, stream>>>(a);
  else if (a.mode == kConsume && a.phase == kGradient)
    tsph_pair_kernel<T, PERIODIC, G, kConsume>
        <<<blocks, kThreads, 0, stream>>>(a);
  else if (a.mode == kConsume)
    tsph_pair_kernel<T, PERIODIC, M, kConsume>
        <<<blocks, kThreads, 0, stream>>>(a);
  else if (a.phase == kDensity)
    tsph_pair_kernel<T, PERIODIC, D, kWalk>
        <<<blocks, kThreads, 0, stream>>>(a);
  else if (a.phase == kGradient)
    tsph_pair_kernel<T, PERIODIC, G, kWalk>
        <<<blocks, kThreads, 0, stream>>>(a);
  else
    tsph_pair_kernel<T, PERIODIC, M, kWalk>
        <<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND, int DIM>
cudaError_t launch_dim(const TsphArgs& a, cudaStream_t stream) {
  return a.periodic ? launch_walk<T, KIND, DIM, true>(a, stream)
                    : launch_walk<T, KIND, DIM, false>(a, stream);
}

// the dimensions this library holds
inline bool built_dim(int dim) {
#ifdef TSPH_DIM3
  return dim == 3;
#else
  return dim == 1 || dim == 2;
#endif
}

template <typename T>
cudaError_t launch(const TsphArgs& a, cudaStream_t stream) {
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    constexpr int K = decltype(kind)::value;
#ifdef TSPH_DIM3
    return launch_dim<T, K, 3>(a, stream);
#else
    return a.dim == 1 ? launch_dim<T, K, 1>(a, stream)
                      : launch_dim<T, K, 2>(a, stream);
#endif
  });
}

// the planes each set reads (ops/tsph_pair.py pack_layout)
int planes_of(int phase) { return phase == kMomentum ? kTsphPlanes : 2; }

// each set's outputs: [first, last] of TsphOut
void outputs_of(int phase, int& first, int& last) {
  first = phase == kDensity ? oRho : phase == kGradient ? oInvtt : oAu;
  last = phase == kDensity ? oDndh : phase == kGradient ? oGradv : oAe;
}

bool args_ok(const TsphArgs& a) {
  const bool phase_ok = a.phase >= kDensity && a.phase <= kMomentum;
  const int set_terms = a.phase == kDensity    ? kSden
                        : a.phase == kGradient ? kGradv
                                               : kMom;
  bool sources_ok = a.n_src >= 1 && a.n_src <= kTsphSources &&
                    a.pack.n_src == (a.pack.n_src ? a.n_src : 0);
  for (int s = 0; sources_ok && s < a.n_src; ++s) {
    const TsphSrc& S = a.src[s];
    sources_ok = S.terms == set_terms && S.cell_start != nullptr &&
                 S.cell_end != nullptr;
    for (int q = 0; q < planes_of(a.phase); ++q)
      sources_ok = sources_ok && S.plane[q] != nullptr;
  }
  bool outs_ok = true;
  int first, last;
  outputs_of(a.phase, first, last);
  if (a.mode == kSweep) {
    for (int k = 0; k < kSweepOut; ++k)
      outs_ok = outs_ok && a.sw[k] != nullptr && a.swpre[k] != nullptr;
    outs_ok = outs_ok && a.phase == kDensity && a.h0 != nullptr &&
              a.unconv != nullptr && a.overflow != nullptr;
  } else {
    for (int k = first; k <= last; ++k)
      outs_ok = outs_ok && a.pre[k] != nullptr && a.out[k] != nullptr;
  }
  if (a.mode == kConsume) {
    outs_ok = outs_ok && a.phase != kDensity && a.use != nullptr;
    for (int s = 0; s < a.n_src; ++s)
      outs_ok = outs_ok && a.hplane[s] != nullptr;
  }
  const bool list_ok =
      a.mode == kWalk ||
      (a.cap >= 1 && a.nbr != nullptr && a.lcount != nullptr);
  return sources_ok && outs_ok && list_ok &&
         (a.mode == kWalk || a.mode == kSweep || a.mode == kConsume) &&
         a.nx >= 1 && a.ny >= 1 && a.nz >= 1 && built_dim(a.dim) &&
         (a.dtype == 0 || a.dtype == 1) &&
         shapes::built_kind(a.kernel_kind) && phase_ok &&
         a.dorder != nullptr && a.cell != nullptr &&
         pack::args_ok(a.pack) && a.pack.dtype == a.dtype;
}

}  // namespace

extern "C" {

int tsph_pair_args_size() { return static_cast<int>(sizeof(TsphArgs)); }

int tsph_pair_launch(const TsphArgs* args, void* stream) {
  TsphArgs a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the sweep's pack runs under its gate; a launch that reads the last
  // sweep's copy leaves plane 0 unpacked
  a.pack.run = a.mode == kSweep ? a.run : nullptr;
  a.pack.skip0 = a.mode == kConsume ? a.use : nullptr;
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                       : launch<double>(a, st));
}

const char* tsph_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
