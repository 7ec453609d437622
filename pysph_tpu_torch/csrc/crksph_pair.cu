// CRKSPH pair kernel for Hopper (sm_90a): the six pair phase sets of
// CRKSPHScheme (sph/wc/crksph.py), the reproducing-kernel moments and the
// corrected symmetric gradient, over the warp-coherent walk of
// csrc/cell_walk.cuh and the cell-sorted packed sources of
// csrc/cell_pack.cuh, on an open or a periodic grid.
//
// Replaces the TPU's pair kernels for CRKSPHScheme's groups:
// pysph_tpu/ops/resident.py::_pair_kernel_resident (:645, its pallas_call
// :1290) where the resident runner takes the first evaluator, and
// pysph_tpu/ops/pallas_engine.py::_pair_kernel_compact (:1160, its
// pallas_call :1867; "sequential phases" and "strided props", :856-866),
// which takes the groups that rewrite DWIJ before a later equation reads
// it and the stride-9/27 moments.  One launch computes one dest's set over
// all its sources (at most 4); the sets, by phase id (ops/crksph_pair.py
// PHASE_SETS):
//
//   kNumDen   NumberDensity: WI                        -> V
//   kMoments  CRKSPHPreStep.loop: V_j^-1 {W, W x, W x x, DW, x DW + d W,
//             x x DW + (x d + d x) W}, W and DW at HIJ, and a count
//             -> crk_m0 m1 m2 gm0 gm1 gm2 nnbr (the first DIM components)
//   kRho      CRKSPHSymmetric, SummationDensityCRKSPH: the pair factor
//             A_i (1 + B_i . x) W, V_j^-1            -> rho rhofac
//   kGradV    CRKSPHSymmetric, VelocityGradient: the corrected DWI
//             -> gradv
//   kMom      CRKSPHSymmetric, MomentumEquation [, LaminarViscosity on the
//             corrected DWIJ]: the limited Q of both sides' gradv
//             -> au av aw
//   kEnergy   CRKSPHSymmetric, EnergyEquation: the limiter on u0, the
//             entropy-weighted split                   -> ae
//
// The corrected gradient of a side, as CRKSPHSymmetric: (a DW + ga W)(1 +
// b.x) + a (gb x + b) W over the first DIM components, with the dest's A,
// B at its h and the source's at its h (x negated); DWIJ is half their
// difference, and its components past DIM keep the kernel's gradient at
// HIJ.  cwij (A_i, in pysph_tpu's choice) is the equation's initialize,
// not a pair sum.  Each output is pre + sum on rows under the write mask
// and pre elsewhere, every column of a strided output written in one pass
// (the columns past DIM keep pre); every read sees the value from before
// the phase.  h varies per particle: a pair is in support where r < rs
// max(hi, hj).  DIM is a template parameter (2 or 3; 1D, which needs
// mirror ghosts, is ROADMAP Queue 1 item 27 and the wrapper raises).  The
// shape is a kind of csrc/shapes.cuh, a template parameter: the default
// library holds QuinticSpline alone (kind 3, the scheme's), every other
// kind is a library of its own (-DPAIR_KIND=k, ops/crksph_pair.py).
//
// Design.  A group of G lanes takes a dest (csrc/group_walk.cuh: thread t
// the dest at position t / G of the dest's sorted order as lane t mod G,
// each lane a stride of every stencil range, the group's sums added by a
// __shfl_xor_sync butterfly, lane 0 storing them), G by set and dtype
// (kLanes, chosen by a measured sweep: tools_dev/list_batch.py
// crksph_pair).  At the accuracy test's 65,536 dests a thread a dest
// filled ~15 of an SM's 64 warp slots; G lanes fill G times as many.  On
// a periodic grid (the template flag PERIODIC) the rows wrap and each
// displacement is the minimum image, from the stencil range's wrap where
// it can be (csrc/group_walk.cuh).  No shared memory.
//
// One neighbour list an evaluation (ops/pair_link.py).  Five of the six
// sets run in CRKSPHScheme's first evaluator with nothing between them
// that moves x y z h, so they share one walk (mode, CrkMode): the number
// density launch (kEmit) walks and writes each dest's pairs in support in
// the walk's order, entry c of the dest at sorted position p at nbr[c *
// n_dest + p] (source s's position k numbered base_s + k) for c < cap,
// lcount[p] its pairs (which may exceed cap: each such dest adds one to
// *overflow); the moments, density, velocity gradient and momentum
// launches (kRead) read plane 0 from the emitting launch's copy, pack only
// their further planes, and take list entries r, r + G, ... of their dest
// instead of walking, a warp holding a dest past cap walking as kWalk
// does.  The energy launch, the second evaluator's only set, walks
// (kWalk), as every set does unlinked.
//
// Each source is read from its packed copy (launched by this file's
// launch function just before the kernel), whose record planes are, as
// ops/crksph_pair.py PACK_RECORDS[DIM]: in 2D
//   plane 0: x y z h
//   plane 1: u v w m
//   plane 2: rho p cs V
//   plane 3: ai bi:0 bi:1 gradai:0
//   plane 4: gradai:1 gradbi:0 gradbi:1 gradbi:3
//   plane 5: gradbi:4 gradv:0 gradv:1 gradv:2
//   plane 6: gradv:3 u0 v0 w0
// and in 3D planes 0-2 and
//   plane 3: ai bi:0 bi:1 bi:2
//   plane 4: gradai:0 gradai:1 gradai:2 gradbi:0
//   plane 5: gradbi:1 gradbi:2 gradbi:3 gradbi:4
//   plane 6: gradbi:5 gradbi:6 gradbi:7 gradbi:8
//   plane 7: gradv:0 gradv:1 gradv:2 gradv:3
//   plane 8: gradv:4 gradv:5 gradv:6 gradv:7
//   plane 9: gradv:8 u0 v0 w0
// (p:c is column c of the strided p; planes 3 on hold one flat record of
// the source's coefficients, the first DIM components of each, packed once
// a call): kNumDen packs plane 0, kMoments and kRho planes 0 and 2,
// kGradV 0-2, kMom and kEnergy all; a reading launch all but plane 0.
// Built with -fmad=false (ops/build.py EXTRA_FLAGS): the support test and
// the pair body round each operation as the plain version's, so the pairs
// and each dest's count are its exactly.
//
// What bounds it: operations.  kMom and kEnergy evaluate the shape at
// three smoothing lengths a pair (WI DWI, WJ DWJ; HIJ only for a 2D pair
// off the plane) and ~200 flops on up to 7 (2D) or 10 (3D) records;
// kMoments one shape and ~40 (2D) or ~110 (3D) flops; the walk tests ~3.6
// candidates a pair (the accuracy test at 256^2, QuinticSpline at h = 2
// dx), which the list spares four launches of five.
//
// Variants for the measured sweep (tools_dev/list_batch.py crksph_pair):
// CRKSPH_LANES (G of every set and dtype), CRKSPH_BLOCKS and
// CRKSPH_BLOCKS_F64 (the launch bounds' blocks an SM, float32 and
// float64), CRKSPH_SWEEP (the 2D periodic kernels alone).
//
// Interface: plain C, called through ctypes (ops/crksph_pair.py).  The
// launch function takes a host pointer to CrkArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack and
// then the kernel, and returns cudaGetLastError().

#ifndef PAIR_KIND
#define PAIR_KIND 3
#endif

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "group_walk.cuh"
#include "shapes.cuh"

constexpr int kCrkSources = 4;
constexpr int kCrkPlanes = 10;
// phase ids, as ops/crksph_pair.py KERNEL_PHASE
enum CrkPhase { kNumDen, kMoments, kRho, kGradV, kMom, kEnergy, kCrkPhases };
// outputs in the order of ops/crksph_pair.py OUTPUTS
enum CrkOut {
  oV, oM0, oM1, oM2, oGm0, oGm1, oGm2, oNnbr, oRho, oRhofac, oGradv, oAu,
  oAv, oAw, oAe, kCrkOut
};
// the record planes of a packed copy
enum CrkPlane { kPos, kVelM, kThermo, kCoef };
// walk; walk and write the neighbour list; read it (ops/crksph_pair.py)
enum CrkMode { kWalk, kEmit, kRead };

struct CrkSrc {
  // the packed copy's planes, in the source's cell order; null where the
  // set reads none of the plane's props
  const void* plane[kCrkPlanes];
  const int32_t* cell_start;  // per cell: first position in the copy
  const int32_t* cell_end;    // per cell: one past the last
  int32_t terms;              // the set's term mask (args_ok checks it)
  int32_t base;               // set by the shared fill; no list reads it
};

struct CrkArgs {
  // dest, stride 1
  const void *x, *y, *z, *h, *u, *v, *w, *u0, *v0, *w0, *m, *rho, *p, *cs,
      *V, *ai;
  // dest, strided: bi (n, 3), gradai (n, 3), gradbi (n, 9), gradv (n, 9)
  const void *bi, *gradai, *gradbi, *gradv;
  const int32_t* cell;         // dest cell id, ix + nx * (iy + ny * iz)
  const int32_t* dorder;       // the dest's cell order: threads follow it
  const uint8_t* wmask;        // write mask (bool); null: every row
  const void* pre[kCrkOut];    // values before the phase; null: unused
  void* out[kCrkOut];
  int32_t* count;              // non-null: each dest's pairs in support
  CrkSrc src[kCrkSources];
  double radius_scale, kfac;   // kfac: the kernel's sigma
  double box[3];  // the length of each periodic axis, 0 on the others
  // MomentumEquation's or EnergyEquation's constants; LaminarViscosity's
  double cl, cq, eta_crit, eta_fold, gamma, nu, eta;
  int32_t n_dest, n_src, nx, ny, nz, dim, phase, dtype, kernel_kind,
      periodic, visc;
  // the list (cap, n_dest), each dest's count and kEmit's count of dests
  // past cap
  int32_t mode, cap;
  int32_t* nbr;
  int32_t* lcount;
  int32_t* overflow;
  PackArgs pack;
};

namespace {

using walk::Rec;
using walk::rec;

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

// One pair in support: k, the source particle's position in its packed
// copy; XIJ (the minimum image on a periodic grid), RIJ, 1 / RIJ (0 at
// RIJ = 0, as the torch pair engine's RINV) and the source's h.
template <typename T>
struct Pair {
  int k;
  T xij, yij, zij, rij, rinv, hj;
};

// The kernel of shape KIND at one smoothing length h: h1 = 1 / h (1 where
// h <= 0), fac = sigma h1^DIM, as the torch pair engine's _kparts.
template <typename T, int KIND, int DIM>
struct AtH {
  T h1, fac;
  __device__ __forceinline__ void set(T h, T kfac) {
    h1 = T(1) / (h > T(0) ? h : T(1));
    fac = kfac * (DIM == 2 ? h1 * h1 : h1 * h1 * h1);
  }
};

// the widths of the strided outputs (ops/crksph_pair.py WIDTH)
__host__ __device__ constexpr int width_of(int o) {
  return o == oM1 || o == oGm0 ? 3
         : o == oM2 || o == oGm1 || o == oGradv ? 9
         : o == oGm2 ? 27 : 1;
}

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

// W and the gradient's factor G (DW = G XIJ; 0 where RIJ <= 1e-12) at the
// smoothing length of `at`, from one shape evaluation
template <typename T, int KIND, int DIM>
__device__ __forceinline__ void kernel_at(const AtH<T, KIND, DIM>& at,
                                          const Pair<T>& q, T& W, T& G) {
  T w, dw;
  shapes::shape<T, KIND>(q.rij * at.h1, w, dw);
  W = w * at.fac;
  G = q.rij > T(1e-12) ? dw * at.fac * at.h1 * q.rinv : T(0);
}

// torch.clamp(x, max=c) and torch.clamp(x, min=c): NaN propagates
template <typename T>
__device__ __forceinline__ T clamp_max(T x, T c) {
  return (x != x || x < c) ? x : c;
}
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T c) {
  return (x != x || x > c) ? x : c;
}
// torch.minimum: a NaN of either side propagates
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// One side's reproducing-kernel coefficients, the first DIM components:
// A, B, grad A and grad B (gb[g][a] = d B_a / d x_g), and gradv (d-packed,
// gv[DIM a + b]).
template <typename T, int DIM>
struct Coef {
  T a, b[DIM], ga[DIM], gb[DIM][DIM], gv[DIM * DIM];
};

// the number of values of the flat record of planes kCoef on
template <int DIM>
__host__ __device__ constexpr int coef_values() {
  return 1 + 2 * DIM + 2 * DIM * DIM + 3;
}

// The dest's coefficients, from its strided props.
template <typename T, int DIM>
__device__ __forceinline__ void load_dest(const CrkArgs& a, int i,
                                          Coef<T, DIM>& c, bool gradv) {
  c.a = ld<T>(a.ai, i);
#pragma unroll
  for (int g = 0; g < DIM; ++g) {
    c.b[g] = ld<T>(a.bi, 3 * i + g);
    c.ga[g] = ld<T>(a.gradai, 3 * i + g);
#pragma unroll
    for (int k = 0; k < DIM; ++k) c.gb[g][k] = ld<T>(a.gradbi, 9 * i + 3 * g + k);
  }
#pragma unroll
  for (int k = 0; k < DIM * DIM; ++k)
    c.gv[k] = gradv ? ld<T>(a.gradv, 9 * i + k) : T(0);
}

// A source's coefficients and u0 v0 w0 from its flat record (planes
// kCoef on): ai, bi, gradai, gradbi, gradv, u0, v0, w0.
template <typename T, int DIM>
__device__ __forceinline__ void load_source(const CrkSrc& S, int k,
                                            Coef<T, DIM>& c, T* u0) {
  constexpr int kRecs = (coef_values<DIM>() + 3) / 4;
  T f[4 * kRecs];
#pragma unroll
  for (int r = 0; r < kRecs; ++r) {
    const Rec<T> v = rec<T>(S.plane[kCoef + r], k);
    f[4 * r] = v.a;
    f[4 * r + 1] = v.b;
    f[4 * r + 2] = v.c;
    f[4 * r + 3] = v.d;
  }
  int o = 0;
  c.a = f[o++];
#pragma unroll
  for (int g = 0; g < DIM; ++g) c.b[g] = f[o++];
#pragma unroll
  for (int g = 0; g < DIM; ++g) c.ga[g] = f[o++];
#pragma unroll
  for (int g = 0; g < DIM; ++g)
#pragma unroll
    for (int k2 = 0; k2 < DIM; ++k2) c.gb[g][k2] = f[o++];
#pragma unroll
  for (int k2 = 0; k2 < DIM * DIM; ++k2) c.gv[k2] = f[o++];
#pragma unroll
  for (int d = 0; d < 3; ++d) u0[d] = f[o++];
}

// CRKSPHSymmetric's corrected gradient of one side: the dest's (sign 1,
// its W and DW at hi) or the source's (sign -1, at hj), as its loop sums:
// (sign a DW + ga W)(1 + bx) + a (dbx + b) W, bx and dbx summed from 0 over
// sign * b XIJ and sign * gb XIJ.
template <typename T, int DIM, int SIGN>
__device__ __forceinline__ void corrected(const Coef<T, DIM>& c, T W,
                                          const T* dw, const T* x, T* out) {
  T bx = T(0);
#pragma unroll
  for (int al = 0; al < DIM; ++al)
    bx = SIGN > 0 ? bx + c.b[al] * x[al] : bx - c.b[al] * x[al];
#pragma unroll
  for (int g = 0; g < DIM; ++g) {
    T dbx = T(0);
#pragma unroll
    for (int al = 0; al < DIM; ++al)
      dbx = SIGN > 0 ? dbx + c.gb[g][al] * x[al] : dbx - c.gb[g][al] * x[al];
    const T adw = SIGN > 0 ? c.a * dw[g] : -c.a * dw[g];
    T r = (adw + c.ga[g] * W) * (T(1) + bx);
    out[g] = r + c.a * (dbx + c.b[g]) * W;
  }
}

// The limiter of the momentum and energy equations (crksph.py _limiter):
// (mui, muj) from both sides' gradv, XIJ, hi, hj, EPS and the relative
// velocity vij.
template <typename T, int DIM>
__device__ __forceinline__ void limiter(const T* gvi, const T* gvj,
                                        const T* x, T hi, T hj, T eta_crit,
                                        T eta_fold, T eps, const T* vij,
                                        T& mui, T& muj) {
  T tri = T(0), trj = T(0);
#pragma unroll
  for (int al = 0; al < DIM; ++al)
#pragma unroll
    for (int be = 0; be < DIM; ++be) {
      tri = tri + gvi[DIM * al + be] * x[al] * x[be];
      trj = trj + gvj[DIM * al + be] * x[al] * x[be];
    }
  const bool safe = fabs(trj) > T(1e-30);
  const T rij = safe ? tri / trj : T(1);
  const T tmprij = clamp_max(T(4) * rij / ((T(1) + rij) * (T(1) + rij)),
                             T(1));
  T phi = clamp_min(tmprij, T(0));
  const T r2 = x[0] * x[0] + x[1] * x[1] + x[2] * x[2];
  const T r = sqrt(r2);
  const T etaij = tmin(r / hi, r / hj);
  const T tphi = (etaij - eta_crit) / eta_fold;
  if (etaij < eta_crit) phi = phi * exp(-tphi * tphi);
  T udotx = T(0);
#pragma unroll
  for (int al = 0; al < DIM; ++al) {
    T s = T(0);
#pragma unroll
    for (int be = 0; be < DIM; ++be)
      s = s + (gvi[DIM * al + be] + gvj[DIM * al + be]) * x[be];
    const T uhat = vij[al] - T(0.5) * phi * s;
    udotx = al == 0 ? uhat * x[al] : udotx + uhat * x[al];
  }
  mui = clamp_max(udotx / (r2 / hi + eps * hi), T(0));
  muj = clamp_max(udotx / (r2 / hi + eps * hj), T(0));
}

// ---------------------------------------------------------------- sets

// NumberDensity: V += WI.
template <typename T, int KIND, int DIM>
struct NumDen {
  static constexpr int kPhase = kNumDen;
  AtH<T, KIND, DIM> at{};
  T v = 0;
  __device__ void load(const CrkArgs& a, int i) {
    at.set(ld<T>(a.h, i), T(a.kfac));
  }
  __device__ void pair(const CrkArgs&, const CrkSrc&, const Pair<T>& q) {
    T W, G;
    kernel_at(at, q, W, G);
    v += W;
  }
  template <int L>
  __device__ void reduce() {
    v = group::sum<L>(v);
  }
  __device__ void store(const CrkArgs& a, int i, bool wm) {
    const T pre = ld<T>(a.pre[oV], i);
    static_cast<T*>(a.out[oV])[i] = wm ? pre + v : pre;
  }
};

// CRKSPHPreStep.loop: the moments, W and DW at HIJ; m2 and gm2 summed once
// for each (a <= b), which they are symmetric in.
template <typename T, int KIND, int DIM>
struct Moments {
  static constexpr int kPhase = kMoments;
  static constexpr int kSym = DIM * (DIM + 1) / 2;
  T hi = 0, kfac = 0;
  T m0 = 0, nn = 0, m1[DIM] = {}, m2[kSym] = {}, gm0[DIM] = {},
    gm1[DIM * DIM] = {}, gm2[DIM * kSym] = {};
  __device__ void load(const CrkArgs& a, int i) {
    hi = ld<T>(a.h, i);
    kfac = T(a.kfac);
  }
  __device__ void pair(const CrkArgs&, const CrkSrc& S, const Pair<T>& q) {
    AtH<T, KIND, DIM> at;
    at.set(T(0.5) * (hi + q.hj), kfac);
    T W, G;
    kernel_at(at, q, W, G);
    const T V = T(1) / rec<T>(S.plane[kThermo], q.k).d;
    const T x[3] = {q.xij, q.yij, q.zij};
    T dw[DIM];
#pragma unroll
    for (int g = 0; g < DIM; ++g) dw[g] = G * x[g];
    nn += T(1) + T(0) * W;
    const T vw = V * W;
    m0 += vw;
    int s = 0;
#pragma unroll
    for (int al = 0; al < DIM; ++al) {
      m1[al] += vw * x[al];
#pragma unroll
      for (int be = al; be < DIM; ++be) m2[s++] += vw * x[al] * x[be];
    }
#pragma unroll
    for (int g = 0; g < DIM; ++g) {
      gm0[g] += V * dw[g];
#pragma unroll
      for (int al = 0; al < DIM; ++al)
        gm1[DIM * g + al] += V * (x[al] * dw[g] + T(al == g) * W);
      int t = 0;
#pragma unroll
      for (int al = 0; al < DIM; ++al)
#pragma unroll
        for (int be = al; be < DIM; ++be) {
          const T tmp = x[al] * T(be == g) + x[be] * T(al == g);
          gm2[kSym * g + t++] += V * (x[al] * x[be] * dw[g] + tmp * W);
        }
    }
  }
  template <int L>
  __device__ void reduce() {
    m0 = group::sum<L>(m0);
    nn = group::sum<L>(nn);
#pragma unroll
    for (int c = 0; c < DIM; ++c) {
      m1[c] = group::sum<L>(m1[c]);
      gm0[c] = group::sum<L>(gm0[c]);
    }
#pragma unroll
    for (int c = 0; c < kSym; ++c) m2[c] = group::sum<L>(m2[c]);
#pragma unroll
    for (int c = 0; c < DIM * DIM; ++c) gm1[c] = group::sum<L>(gm1[c]);
#pragma unroll
    for (int c = 0; c < DIM * kSym; ++c) gm2[c] = group::sum<L>(gm2[c]);
  }
  // column c of output o: pre + the sum where it is summed
  __device__ static void put(const CrkArgs& a, int o, int i, int c, bool wm,
                             bool summed, T sum) {
    const int W = width_of(o);
    const T pre = ld<T>(a.pre[o], W * i + c);
    static_cast<T*>(a.out[o])[W * i + c] = wm && summed ? pre + sum : pre;
  }
  __device__ void store(const CrkArgs& a, int i, bool wm) {
    put(a, oM0, i, 0, wm, true, m0);
    put(a, oNnbr, i, 0, wm, true, nn);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      put(a, oM1, i, c, wm, c < DIM, c < DIM ? m1[c] : T(0));
      put(a, oGm0, i, c, wm, c < DIM, c < DIM ? gm0[c] : T(0));
    }
    // d-packed: m2[DIM a + b], gm1[DIM g + a], gm2[DIM DIM g + DIM a + b]
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const int al = c / DIM, be = c % DIM;
      const bool in = c < DIM * DIM;
      const int lo = al < be ? al : be, hi2 = al < be ? be : al;
      // the symmetric index of (lo, hi2): rows lo of the upper triangle
      const int s = lo * DIM - lo * (lo - 1) / 2 + (hi2 - lo);
      put(a, oM2, i, c, wm, in, in ? m2[s] : T(0));
      put(a, oGm1, i, c, wm, in, in ? gm1[c] : T(0));
    }
#pragma unroll
    for (int c = 0; c < 27; ++c) {
      const bool in = c < DIM * DIM * DIM;
      const int g = c / (DIM * DIM), r = c % (DIM * DIM);
      const int al = r / DIM, be = r % DIM;
      const int lo = al < be ? al : be, hi2 = al < be ? be : al;
      const int s = lo * DIM - lo * (lo - 1) / 2 + (hi2 - lo);
      put(a, oGm2, i, c, wm, in, in ? gm2[kSym * g + s] : T(0));
    }
  }
};

// CRKSPHSymmetric, SummationDensityCRKSPH: W at HIJ, the pair factor
// A_i (1 + B_i . x) over the three components of B_i.
template <typename T, int KIND, int DIM>
struct Density {
  static constexpr int kPhase = kRho;
  T hi = 0, kfac = 0, mi = 0, ai = 0, b[3] = {};
  T rho = 0, rhofac = 0;
  __device__ void load(const CrkArgs& a, int i) {
    hi = ld<T>(a.h, i);
    kfac = T(a.kfac);
    mi = ld<T>(a.m, i);
    ai = ld<T>(a.ai, i);
#pragma unroll
    for (int c = 0; c < 3; ++c) b[c] = ld<T>(a.bi, 3 * i + c);
  }
  __device__ void pair(const CrkArgs&, const CrkSrc& S, const Pair<T>& q) {
    AtH<T, KIND, DIM> at;
    at.set(T(0.5) * (hi + q.hj), kfac);
    T W, G;
    kernel_at(at, q, W, G);
    const T bx = b[0] * q.xij + b[1] * q.yij + b[2] * q.zij;
    const T cw = ai * (T(1) + bx);
    const T Vj = T(1) / rec<T>(S.plane[kThermo], q.k).d;
    const T fac = Vj * cw * W;
    rho += mi * fac;
    rhofac += Vj * fac;
  }
  template <int L>
  __device__ void reduce() {
    rho = group::sum<L>(rho);
    rhofac = group::sum<L>(rhofac);
  }
  __device__ void store(const CrkArgs& a, int i, bool wm) {
    const T p0 = ld<T>(a.pre[oRho], i), p1 = ld<T>(a.pre[oRhofac], i);
    static_cast<T*>(a.out[oRho])[i] = wm ? p0 + rho : p0;
    static_cast<T*>(a.out[oRhofac])[i] = wm ? p1 + rhofac : p1;
  }
};

// CRKSPHSymmetric, VelocityGradient: the dest's corrected DWI at hi.
template <typename T, int KIND, int DIM>
struct GradV {
  static constexpr int kPhase = kGradV;
  AtH<T, KIND, DIM> at{};
  Coef<T, DIM> ci{};
  T ui = 0, vi = 0, wi = 0;
  T gv[DIM * DIM] = {};
  __device__ void load(const CrkArgs& a, int i) {
    at.set(ld<T>(a.h, i), T(a.kfac));
    load_dest(a, i, ci, false);
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
  }
  __device__ void pair(const CrkArgs&, const CrkSrc& S, const Pair<T>& q) {
    T W, G;
    kernel_at(at, q, W, G);
    const T x[3] = {q.xij, q.yij, q.zij};
    T dw[DIM], dwi[DIM];
#pragma unroll
    for (int g = 0; g < DIM; ++g) dw[g] = G * x[g];
    corrected<T, DIM, 1>(ci, W, dw, x, dwi);
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);  // u v w m
    const T Vj = T(1) / rec<T>(S.plane[kThermo], q.k).d;
    const T vij[3] = {ui - vm.a, vi - vm.b, wi - vm.c};
#pragma unroll
    for (int al = 0; al < DIM; ++al)
#pragma unroll
      for (int be = 0; be < DIM; ++be)
        gv[DIM * al + be] += -Vj * vij[al] * dwi[be];
  }
  template <int L>
  __device__ void reduce() {
#pragma unroll
    for (int c = 0; c < DIM * DIM; ++c) gv[c] = group::sum<L>(gv[c]);
  }
  __device__ void store(const CrkArgs& a, int i, bool wm) {
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const T pre = ld<T>(a.pre[oGradv], 9 * i + c);
      const bool in = c < DIM * DIM;
      static_cast<T*>(a.out[oGradv])[9 * i + c] =
          wm && in ? pre + gv[in ? c : 0] : pre;
    }
  }
};

// What the momentum and energy sets share: the dest's props, and a pair's
// corrected DWIJ (its components past DIM the kernel's gradient at HIJ)
// and the limited Q's factor fac = -(1 / m_i) V_i^-1 V_j^-1 (p_i + p_j +
// Q_i + Q_j), the limiter on the velocities vij.
template <typename T, int KIND, int DIM>
struct Symmetric {
  AtH<T, KIND, DIM> at{};
  Coef<T, DIM> ci{};
  T hi = 0, kfac = 0, ui = 0, vi = 0, wi = 0, mi = 0, rhoi = 0, p_i = 0,
    csi = 0, Vi = 0;
  __device__ void load_common(const CrkArgs& a, int i) {
    hi = ld<T>(a.h, i);
    kfac = T(a.kfac);
    at.set(hi, kfac);
    load_dest(a, i, ci, true);
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    mi = ld<T>(a.m, i);
    rhoi = ld<T>(a.rho, i);
    p_i = ld<T>(a.p, i);
    csi = ld<T>(a.cs, i);
    Vi = ld<T>(a.V, i);
  }
  // DWIJ (3 components) of pair q with the source's coefficients cj
  __device__ void dwij_of(const Pair<T>& q, const Coef<T, DIM>& cj,
                          T* dwij) const {
    const T x[3] = {q.xij, q.yij, q.zij};
    T Wi, Gi, Wj, Gj;
    kernel_at(at, q, Wi, Gi);
    AtH<T, KIND, DIM> atj;
    atj.set(q.hj, kfac);
    kernel_at(atj, q, Wj, Gj);
    T dwi[DIM], dwj[DIM], ti[DIM], tj[DIM];
#pragma unroll
    for (int g = 0; g < DIM; ++g) {
      dwi[g] = Gi * x[g];
      dwj[g] = Gj * x[g];
    }
    corrected<T, DIM, 1>(ci, Wi, dwi, x, ti);
    corrected<T, DIM, -1>(cj, Wj, dwj, x, tj);
#pragma unroll
    for (int g = 0; g < DIM; ++g) dwij[g] = T(0.5) * (ti[g] - tj[g]);
    if (DIM < 3) {
      // the component off the plane: the kernel's gradient at HIJ (0 for
      // a pair in the plane, G being finite)
      T Wij = T(0), Gij = T(0);
      if (q.zij != T(0)) {
        AtH<T, KIND, DIM> atij;
        atij.set(T(0.5) * (hi + q.hj), kfac);
        kernel_at(atij, q, Wij, Gij);
      }
      dwij[2] = Gij * q.zij;
    }
  }
  // fac of the pair: the limiter on vij, with the source's thermo record
  // {rho p cs V} and gradv gvj, and the set's constants
  __device__ T fac_of(const CrkArgs& a, const Pair<T>& q, const Rec<T>& th,
                      const T* gvj, const T* vij) const {
    const T x[3] = {q.xij, q.yij, q.zij};
    const T hij = T(0.5) * (hi + q.hj);
    const T eps = T(0.01) * hij * hij;
    T mui, muj;
    limiter<T, DIM>(ci.gv, gvj, x, hi, q.hj, T(a.eta_crit), T(a.eta_fold),
                    eps, vij, mui, muj);
    const T cl = T(a.cl), cq = T(a.cq);
    const T Qi = rhoi * (-cl * csi * mui + cq * mui * mui);
    const T Qj = th.a * (-cl * th.c * muj + cq * muj * muj);
    const T Vii = T(1) / Vi, Vj = T(1) / th.d;
    return -(T(1) / mi) * Vii * Vj * (p_i + th.b + Qi + Qj);
  }
};

// CRKSPHSymmetric, MomentumEquation [, LaminarViscosity].
template <typename T, int KIND, int DIM>
struct Mom : Symmetric<T, KIND, DIM> {
  static constexpr int kPhase = kMom;
  using B = Symmetric<T, KIND, DIM>;
  T au = 0, av = 0, aw = 0;
  __device__ void load(const CrkArgs& a, int i) { B::load_common(a, i); }
  __device__ void pair(const CrkArgs& a, const CrkSrc& S, const Pair<T>& q) {
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);    // u v w m
    const Rec<T> th = rec<T>(S.plane[kThermo], q.k);  // rho p cs V
    Coef<T, DIM> cj;
    T u0j[3];
    load_source(S, q.k, cj, u0j);
    T dwij[3];
    B::dwij_of(q, cj, dwij);
    const T vij[3] = {B::ui - vm.a, B::vi - vm.b, B::wi - vm.c};
    const T fac = B::fac_of(a, q, th, cj.gv, vij);
    au += fac * dwij[0];
    av += fac * dwij[1];
    aw += fac * dwij[2];
    if (a.visc) {
      // LaminarViscosity on the corrected DWIJ
      const T fij = dwij[0] * q.xij + dwij[1] * q.yij + dwij[2] * q.zij;
      const T hij = T(0.5) * (B::hi + q.hj);
      const T r2 = q.xij * q.xij + q.yij * q.yij + q.zij * q.zij;
      const T tmp = vm.d * T(4) * T(a.nu) * fij /
                    ((B::rhoi + th.a) * (r2 + T(a.eta) * hij * hij));
      au += tmp * vij[0];
      av += tmp * vij[1];
      aw += tmp * vij[2];
    }
  }
  template <int L>
  __device__ void reduce() {
    au = group::sum<L>(au);
    av = group::sum<L>(av);
    aw = group::sum<L>(aw);
  }
  __device__ void store(const CrkArgs& a, int i, bool wm) {
    const T acc[3] = {au, av, aw};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T pre = ld<T>(a.pre[oAu + k], i);
      static_cast<T*>(a.out[oAu + k])[i] = wm ? pre + acc[k] : pre;
    }
  }
};

// CRKSPHSymmetric, EnergyEquation.
template <typename T, int KIND, int DIM>
struct Energy : Symmetric<T, KIND, DIM> {
  static constexpr int kPhase = kEnergy;
  using B = Symmetric<T, KIND, DIM>;
  T u0i[3] = {}, si = 0, gamma = 0;
  T ae = 0;
  __device__ void load(const CrkArgs& a, int i) {
    B::load_common(a, i);
    u0i[0] = ld<T>(a.u0, i);
    u0i[1] = ld<T>(a.v0, i);
    u0i[2] = ld<T>(a.w0, i);
    gamma = T(a.gamma);
    si = B::p_i / pow(B::rhoi, gamma);
  }
  __device__ void pair(const CrkArgs& a, const CrkSrc& S, const Pair<T>& q) {
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);    // u v w m
    const Rec<T> th = rec<T>(S.plane[kThermo], q.k);  // rho p cs V
    Coef<T, DIM> cj;
    T u0j[3];
    load_source(S, q.k, cj, u0j);
    T dwij[3];
    B::dwij_of(q, cj, dwij);
    const T viju[3] = {u0i[0] - u0j[0], u0i[1] - u0j[1], u0i[2] - u0j[2]};
    const T fac = B::fac_of(a, q, th, cj.gv, viju);
    const T uj[3] = {vm.a, vm.b, vm.c};
    const T ui[3] = {B::ui, B::vi, B::wi};
    T aeij = T(0);
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const T delu = u0j[d] + uj[d] - u0i[d] - ui[d];
      aeij = d == 0 ? delu * (fac * dwij[d]) : aeij + delu * (fac * dwij[d]);
    }
    const T sj = th.b / pow(th.a, gamma);
    const T asi = fabs(si), asj = fabs(sj);
    const T smin = tmin(asi, asj);
    const T smax = (asi != asi || asi > asj) ? asi : asj;
    const T ssum = smin + smax > T(0) ? smin + smax : T(1);
    const T sd = (si - sj) * aeij;
    const T fij = sd > T(0) ? smin / ssum : sd < T(0) ? smax / ssum : T(0.5);
    ae += T(0.5) * fij * aeij;
  }
  template <int L>
  __device__ void reduce() {
    ae = group::sum<L>(ae);
  }
  __device__ void store(const CrkArgs& a, int i, bool wm) {
    const T pre = ld<T>(a.pre[oAe], i);
    static_cast<T*>(a.out[oAe])[i] = wm ? pre + ae : pre;
  }
};

// --------------------------------------------------------------- kernel

constexpr int kThreads = 128;
// listed entries whose loads a lane has in flight
constexpr int kListBatch = 4;

// The lanes a dest (G) and the launch bounds' blocks an SM of each set
// (kNumDen .. kEnergy) by dtype: the measured sweep's choice, each set's
// fastest of G = 1, 2, 4, 8 at 4, 6, 8 blocks (float32) and 2, 3, 4
// (float64) on the accuracy test at 256^2 (tools_dev/list_batch.py
// crksph_pair, PERF.md); a variant of the sweep sets every set's by
// CRKSPH_LANES, CRKSPH_BLOCKS (float32) and CRKSPH_BLOCKS_F64.
template <typename T>
constexpr int lanes_of(int phase) {
#ifdef CRKSPH_LANES
  return CRKSPH_LANES;
#else
  constexpr int f32[kCrkPhases] = {4, 4, 4, 4, 4, 4};
  constexpr int f64[kCrkPhases] = {4, 2, 4, 2, 4, 4};
  return sizeof(T) == 8 ? f64[phase] : f32[phase];
#endif
}

template <typename T>
constexpr int blocks_of(int phase) {
#ifdef CRKSPH_BLOCKS
  if (sizeof(T) == 4) return CRKSPH_BLOCKS;
#endif
#ifdef CRKSPH_BLOCKS_F64
  if (sizeof(T) == 8) return CRKSPH_BLOCKS_F64;
#endif
  constexpr int f32[kCrkPhases] = {8, 8, 8, 8, 6, 6};
  constexpr int f64[kCrkPhases] = {4, 4, 4, 4, 4, 4};
  return sizeof(T) == 8 ? f64[phase] : f32[phase];
}

template <typename T, int KIND, bool PERIODIC, class Set, int G>
__global__ void __launch_bounds__(kThreads, (blocks_of<T>(Set::kPhase)))
    crksph_pair_kernel(const __grid_constant__ CrkArgs a) {
  // the number density emits the list; moments, density, gradient and
  // momentum read it
  constexpr bool kEmits = Set::kPhase == kNumDen;
  constexpr bool kReads = Set::kPhase >= kMoments && Set::kPhase <= kMom;
  // every lane stays to the end: the walk's votes and the group's sums
  // take the whole warp
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int pos = t / G, r = t % G;
  const bool active = pos < a.n_dest;
  const int i = active ? a.dorder[pos] : 0;

  Rec<T> di{};  // {xi, yi, zi, hi}
  Set ph;
  if (active) {
    di = {ld<T>(a.x, i), ld<T>(a.y, i), ld<T>(a.z, i), ld<T>(a.h, i)};
    ph.load(a, i);
  }
  const T rs = T(a.radius_scale);
  const walk::Box<T> box{{T(a.box[0]), T(a.box[1]), T(a.box[2])}};
  int pairs = 0;
  bool walking = true;
  if (kReads && a.mode == kRead) {
    const int count = active ? a.lcount[pos] : 0;
    walking = __any_sync(walk::kFull, count > a.cap);
    // the list runs source by source: s is the source of the entries
    int s = 0;
    for (int c0 = r; !walking && c0 < count; c0 += G * kListBatch) {
      int e[kListBatch];
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        const int c = c0 + G * u;
        e[u] = c < count ? a.nbr[size_t(c) * a.n_dest + pos] : -1;
      }
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (e[u] < 0) continue;
        while (s + 1 < a.n_src && e[u] >= a.src[s + 1].base) ++s;
        const CrkSrc& S = a.src[s];
        const int k = e[u] - S.base;
        ++pairs;
        ph.pair(a, S,
                pair_of<T, PERIODIC>(di, rec<T>(S.plane[kPos], k), k, box));
      }
    }
  }
  if (walking) {
    const bool emit = kEmits && a.mode == kEmit;
    int listed = 0;
    const walk::Lane l = walk::lane_cell(a, active ? a.cell[i] : 0, active);
    group::Walker<T, G> walker;
    walker.begin();
    for (int s = 0; s < a.n_src; ++s) {
      const CrkSrc& S = a.src[s];
      const void* p0 = S.plane[kPos];
      auto body = [&](int k, int tag) {
        ++pairs;
        ph.pair(a, S, group::pair_at<Pair<T>, T, PERIODIC>(
                          di, rec<T>(p0, k), k, tag, box));
      };
      auto list = [&](unsigned found, int wbase) {
        if (emit)
          listed += group::list_window<G>(found, wbase, r, listed, S.base,
                                          a.cap, a.nbr, a.n_dest, pos);
      };
      group::walk_source<T, G, PERIODIC>(a, S.cell_start, S.cell_end, p0, l,
                                         r, di, rs, box, walker, body, list);
      walker.finish(body);
    }
    if (emit && active && r == 0) {
      a.lcount[pos] = listed;
      if (listed > a.cap) atomicAdd(a.overflow, 1);
    }
  }
  ph.template reduce<G>();
  pairs = group::sum<G>(pairs);
  if (active && r == 0) {
    ph.store(a, i, a.wmask == nullptr || a.wmask[i] != 0);
    if (a.count != nullptr) a.count[i] = pairs;
  }
}

template <typename T, int KIND, bool PERIODIC, class Set>
cudaError_t launch_set(const CrkArgs& a, cudaStream_t stream) {
  constexpr int G = lanes_of<T>(Set::kPhase);
  const long long threads = static_cast<long long>(a.n_dest) * G;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  crksph_pair_kernel<T, KIND, PERIODIC, Set, G>
      <<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND, bool PERIODIC, int DIM>
cudaError_t launch_phase(const CrkArgs& a, cudaStream_t stream) {
  switch (a.phase) {
    case kNumDen:
      return launch_set<T, KIND, PERIODIC, NumDen<T, KIND, DIM>>(a, stream);
    case kMoments:
      return launch_set<T, KIND, PERIODIC, Moments<T, KIND, DIM>>(a, stream);
    case kRho:
      return launch_set<T, KIND, PERIODIC, Density<T, KIND, DIM>>(a, stream);
    case kGradV:
      return launch_set<T, KIND, PERIODIC, GradV<T, KIND, DIM>>(a, stream);
    case kMom:
      return launch_set<T, KIND, PERIODIC, Mom<T, KIND, DIM>>(a, stream);
    default:
      return launch_set<T, KIND, PERIODIC, Energy<T, KIND, DIM>>(a, stream);
  }
}

template <typename T, int KIND>
cudaError_t launch_kind(const CrkArgs& a, cudaStream_t stream) {
#ifdef CRKSPH_SWEEP
  // a sweep's variant holds the 2D periodic kernels alone
  if (a.dim != 2 || !a.periodic) return cudaErrorInvalidValue;
  return launch_phase<T, KIND, true, 2>(a, stream);
#else
  if (a.dim == 2)
    return a.periodic ? launch_phase<T, KIND, true, 2>(a, stream)
                      : launch_phase<T, KIND, false, 2>(a, stream);
  return a.periodic ? launch_phase<T, KIND, true, 3>(a, stream)
                    : launch_phase<T, KIND, false, 3>(a, stream);
#endif
}

template <typename T>
cudaError_t launch(const CrkArgs& a, cudaStream_t stream) {
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    return launch_kind<T, decltype(kind)::value>(a, stream);
  });
}

// the planes each set reads: kPos, and kThermo for the moments and the
// density; kPos-kThermo for the gradient; all for momentum and energy
bool planes_ok(const CrkSrc& S, int phase, int dim) {
  if (S.plane[kPos] == nullptr) return false;
  if (phase == kNumDen) return true;
  if (S.plane[kThermo] == nullptr) return false;
  if (phase == kMoments || phase == kRho) return true;
  if (S.plane[kVelM] == nullptr) return false;
  if (phase == kGradV) return true;
  const int recs = dim == 2 ? (coef_values<2>() + 3) / 4
                            : (coef_values<3>() + 3) / 4;
  for (int r = 0; r < recs; ++r)
    if (S.plane[kCoef + r] == nullptr) return false;
  return true;
}

// each set's outputs
bool outputs_ok(const CrkArgs& a) {
  int first = oV, last = oV;
  switch (a.phase) {
    case kMoments: first = oM0; last = oNnbr; break;
    case kRho: first = oRho; last = oRhofac; break;
    case kGradV: first = last = oGradv; break;
    case kMom: first = oAu; last = oAw; break;
    case kEnergy: first = last = oAe; break;
    default: break;
  }
  for (int k = first; k <= last; ++k)
    if (a.pre[k] == nullptr || a.out[k] == nullptr) return false;
  return true;
}

// the dest props each set reads
bool dest_ok(const CrkArgs& a) {
  bool ok = a.x && a.y && a.z && a.h;
  if (a.phase == kRho) ok = ok && a.m && a.ai && a.bi;
  if (a.phase >= kGradV)
    ok = ok && a.u && a.v && a.w && a.ai && a.bi && a.gradai && a.gradbi;
  if (a.phase >= kMom)
    ok = ok && a.m && a.rho && a.p && a.cs && a.V && a.gradv;
  if (a.phase == kEnergy) ok = ok && a.u0 && a.v0 && a.w0;
  return ok;
}

// each source's term mask, as ops/crksph_pair.py PHASE_SETS: a bit a
// set, and LaminarViscosity's (64) beside the momentum set's where visc
int terms_of(const CrkArgs& a) {
  return (1 << a.phase) | (a.phase == kMom && a.visc ? 64 : 0);
}

bool args_ok(const CrkArgs& a) {
  bool sources_ok = a.n_src >= 1 && a.n_src <= kCrkSources;
  for (int s = 0; sources_ok && s < a.n_src; ++s) {
    const CrkSrc& S = a.src[s];
    sources_ok = S.terms == terms_of(a) && S.cell_start != nullptr &&
                 S.cell_end != nullptr && planes_ok(S, a.phase, a.dim);
  }
  // only the number density emits, only the moments, density, gradient
  // and momentum read
  const bool mode_ok =
      a.mode == kWalk ||
      (a.cap >= 1 && a.nbr != nullptr && a.lcount != nullptr &&
       (a.mode == kEmit ? a.phase == kNumDen && a.overflow != nullptr
                        : a.mode == kRead && a.phase >= kMoments &&
                              a.phase <= kMom));
  return sources_ok && a.phase >= 0 && a.phase < kCrkPhases && mode_ok &&
         outputs_ok(a) && dest_ok(a) && a.nx >= 1 && a.ny >= 1 &&
         a.nz >= 1 && (a.dim == 2 || a.dim == 3) &&
         (a.dtype == 0 || a.dtype == 1) &&
         shapes::built_kind(a.kernel_kind) && a.dorder != nullptr &&
         a.cell != nullptr && pack::args_ok(a.pack) &&
         a.pack.dtype == a.dtype;
}

}  // namespace

extern "C" {

int crksph_pair_args_size() { return static_cast<int>(sizeof(CrkArgs)); }

// the lanes a dest of a set (CrkPhase) in a dtype (0 float32, 1 float64)
int crksph_pair_lanes(int phase, int dtype) {
  return dtype == 1 ? lanes_of<double>(phase) : lanes_of<float>(phase);
}

int crksph_pair_launch(const CrkArgs* args, void* stream) {
  const CrkArgs& a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                       : launch<double>(a, st));
}

const char* crksph_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
