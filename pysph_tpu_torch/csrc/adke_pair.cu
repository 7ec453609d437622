// ADKEScheme's pair sets for Hopper (sm_90a): a group of lanes a dest
// over the cell-sorted packed sources of csrc/cell_pack.cuh, on an open or
// a periodic grid, with each particle's own h.
//
// Replaces pysph_tpu/ops/pallas_engine.py::_pair_kernel_compact (:1160,
// its pallas_call :1867), which the TPU runs for ADKEScheme's two pair
// phases (the shock tube, the accuracy test and the hydrostatic box's
// --scheme adke; the resident engine turns itself off for an update_nnps
// group), as csrc/gasd_pair.cu does for GasDScheme's; both take the
// arguments of csrc/gasd_terms.cuh, and ops/gasd_pair.py launches this
// library for the two ADKE phase ids.  Two phase sets, one device functor
// each:
//
//   AdkeDensity   SummationDensityADKE: WIJ at HIJ, DWI at the dest's h
//                 -> rho arho
//   AdkeAccel     ADKEAccelerations: DWIJ at HIJ; Monaghan's viscosity
//                 (XIJ.VIJ < 0) and the ADKE conduction, with each
//                 source's alpha, beta, g1 and g2 -> au av aw ae
//
// One launch computes the pair terms of one dest array over all its
// sources (at most 4) and writes each output once: pre + sum under the
// write mask, pre elsewhere; with a non-null count, each dest's number of
// pairs in support.  The shape is any kind of csrc/shapes.cuh (the
// Gaussian, kind 2, radius scale 3, is the scheme's), a template
// parameter: this library holds kinds 0-3, each later kind is a library
// of its own (ops/build.py kind_flags).
//
// What bounds it: operations.  ADKE's h is 1.5 h0 and the Gaussian's
// support 3 h, so a dest has a few hundred pairs (the accuracy test at
// 256^2: ~500 a dest over both sets, tested among ~1,900 candidates) and
// the dests are few (65,536): a thread a dest left a quarter of the
// card's warp slots filled, each with a long serial chain.  The design:
//
//   Lanes.  A group of kLanes lanes takes a dest: thread t the dest at
//   sorted position t / kLanes as lane r = t mod kLanes of its group, so
//   a warp holds the 32 / kLanes dests of one or two cells.  Every lane
//   of a group walks the stencil ranges of the dest's cell (rows (oz, oy)
//   of cells cx - 1 .. cx + 1, wrapped on a periodic grid as
//   walk::walk_rows_periodic), taking positions k0 + r, k0 + r + kLanes,
//   ... of each range: a group's loads are kLanes consecutive records,
//   which the groups of one cell share.  Each lane holds its candidates
//   in support as windows of 32 of its positions and hands them to the
//   body in rounds (GroupWalker, walk::Walker's rounds over a stride).
//   Each lane sums its own pairs; a butterfly of __shfl_xor_sync over
//   log2 kLanes steps adds the groups' partial sums (every lane ends with
//   the same bits) and lane 0 stores them.  A launch gives the same bits
//   every time; the sums differ from the plain version's order by
//   rounding only.
//
//   The support test is walk::in_support's arithmetic written as single
//   IEEE operations (__fmul_rn and its kin), so that the pairs and each
//   dest's count are exactly the plain version's although this library
//   is built with FMA contraction on (the pair bodies contract).
//
//   The periodic image.  On a periodic axis of length L the minimum image
//   is d - L rint(d / L).  A stencil range's wrap s (-1, 0 or 1) is known
//   from the range; where |d - L s| < L / 4, rint(d / L) is s (the
//   rounding of d / L moves it by far less than 1 / 4), so d - L s has
//   exactly the image's bits without the division; elsewhere (a particle
//   past the box's end since its binning, or a grid of few cells) the
//   division.  The body gets the range's wrap with each candidate (a tag
//   of its window).
//
//   Per-source terms once.  AdkeAccel's launch, after the pack, rewrites
//   each source's plane 3 (packed as 0 0 0 div) as pj / rhoj^2, Hj = g1
//   hj csj + g2 hj^2 (|divj| - divj), 0, divj (adke_terms_kernel), in
//   single IEEE operations, the bits of those expressions; the dest's Hi
//   is computed once a source.
//
// The packed copy's planes are ops/gasd_pair.py PACK_RECORDS (as
// csrc/gasd_pair.cu's): the density set packs planes 0 {x y z h} and 1
// {u v w m}, the accelerations also 2 {rho p cs e} and 3 {omega alpha1
// alpha2 div} of which ADKE reads div.
//
// Variants for the measured sweep (tools_dev/list_batch.py adke_pair):
// ADKE_LANES (1, 2, 4, 8) and the launch bounds' blocks an SM
// (ADKE_DENSITY_BLOCKS and ADKE_ACCEL_BLOCKS in float32, ADKE_BLOCKS_F64).
//
// Interface: plain C, called through ctypes (ops/gasd_pair.py).  The
// launch function takes a host pointer to GasdArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack, the
// accelerations' per-source terms, then the kernel, and returns
// cudaGetLastError(); adke_pair_lanes() gives kLanes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "gasd_terms.cuh"
#include "shapes.cuh"

#ifndef ADKE_LANES
#define ADKE_LANES 8
#endif
#ifndef ADKE_DENSITY_BLOCKS
#define ADKE_DENSITY_BLOCKS 8
#endif
#ifndef ADKE_ACCEL_BLOCKS
#define ADKE_ACCEL_BLOCKS 8
#endif
#ifndef ADKE_BLOCKS_F64
#define ADKE_BLOCKS_F64 4
#endif

namespace {

using gasd::AtH;
using gasd::ld;
using gasd::Pair;
using walk::kFull;
using walk::Rec;
using walk::rec;

constexpr int kLanes = ADKE_LANES;
static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8,
              "a dest's group is 1, 2, 4 or 8 lanes");
constexpr int kThreads = 128;

// single IEEE operations, rounded once whatever the contraction
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float rint_of(float a) { return rintf(a); }
__device__ __forceinline__ double rint_of(double a) { return rint(a); }

// The minimum image of d on an axis of length L (0: not periodic), with
// the bits of walk::image; ls: L s for the range's wrap s (see the top).
template <typename T>
__device__ __forceinline__ T image_at(T d, T L, T ls) {
  if (L == T(0)) return d;
  const T t = sub_rn(d, ls);
  if (fabs(t) < T(0.25) * L) return t;
  return sub_rn(d, mul_rn(L, rint_of(div_rn(d, L))));
}

// A range's wraps s on the three axes as a tag: 2 bits an axis, s + 1.
__device__ __forceinline__ int wrap_tag(int sx, int sy, int sz) {
  return (sx + 1) | (sy + 1) << 2 | (sz + 1) << 4;
}
template <typename T>
__device__ __forceinline__ T shift_of(int tag, int axis, T L) {
  return L * T(((tag >> (2 * axis)) & 3) - 1);
}

// walk::in_support (on the minimum image where periodic) in single IEEE
// operations: the plain version's pairs under any contraction.
template <typename T, bool PERIODIC>
__device__ __forceinline__ bool in_support_rn(const Rec<T>& di,
                                              const Rec<T>& pj, T rs,
                                              const walk::Box<T>& box,
                                              int tag) {
  T x = sub_rn(di.a, pj.a), y = sub_rn(di.b, pj.b), z = sub_rn(di.c, pj.c);
  if (PERIODIC) {
    x = image_at(x, box.len[0], shift_of(tag, 0, box.len[0]));
    y = image_at(y, box.len[1], shift_of(tag, 1, box.len[1]));
    z = image_at(z, box.len[2], shift_of(tag, 2, box.len[2]));
  }
  const T r2 = add_rn(add_rn(mul_rn(x, x), mul_rn(y, y)), mul_rn(z, z));
  const T sup = mul_rn(rs, di.d > pj.d ? di.d : pj.d);
  return r2 < mul_rn(sup, sup);
}

// One pair in support at position k of a range of wrap tag: XIJ (the
// minimum image), RIJ, 1 / RIJ (0 at RIJ = 0) and the source's h.
template <typename T, bool PERIODIC>
__device__ __forceinline__ Pair<T> pair_at(const Rec<T>& di,
                                           const Rec<T>& pj, int k, int tag,
                                           const walk::Box<T>& box) {
  Pair<T> q;
  q.k = k;
  q.xij = di.a - pj.a;
  q.yij = di.b - pj.b;
  q.zij = di.c - pj.c;
  if (PERIODIC) {
    q.xij = image_at(q.xij, box.len[0], shift_of(tag, 0, box.len[0]));
    q.yij = image_at(q.yij, box.len[1], shift_of(tag, 1, box.len[1]));
    q.zij = image_at(q.zij, box.len[2], shift_of(tag, 2, box.len[2]));
  }
  const T r2 = q.xij * q.xij + q.yij * q.yij + q.zij * q.zij;
  q.rinv = r2 > T(1e-24) ? T(1) / sqrt(r2) : T(0);
  q.rij = r2 * q.rinv;
  q.hj = pj.d;
  return q;
}

// A lane's candidates in support not yet handed to the body: window w
// holds bits[w] over its positions base[w] + kLanes b, b = 0..31, of a
// range of wrap tag[w], oldest first; walk::Walker's rounds (see
// csrc/cell_walk.cuh) over a lane's share of each range.  Every lane of
// the warp must call walk and finish together.
template <typename T>
struct GroupWalker {
  unsigned bits[walk::kWindows];
  int base[walk::kWindows];
  int tag[walk::kWindows];

  __device__ void begin() {
#pragma unroll
    for (int w = 0; w < walk::kWindows; ++w) bits[w] = base[w] = tag[w] = 0;
  }

  // One round: each lane hands its oldest held candidate to the body.
  template <class Body>
  __device__ __forceinline__ void round(Body& body) {
    int k = -1, g = 0;
#pragma unroll
    for (int w = 0; w < walk::kWindows; ++w) {
      if (k < 0 && bits[w] != 0) {
        k = base[w] + kLanes * (__ffs(bits[w]) - 1);
        g = tag[w];
        bits[w] &= bits[w] - 1;
      }
    }
    if (k >= 0) body(k, g);
  }

  // Test lane r's positions k0 + r + kLanes j (j = 0, 1, ...) of the
  // range [k0, k0 + n) of wrap tag g: test(record) decides support,
  // pos(k) is candidate k's {x, y, z, h} record.
  template <class Test, class Pos, class Body>
  __device__ __forceinline__ void walk(int k0, int n, int r, int g,
                                       Test& test, Pos& pos, Body& body) {
    const int mine = n > r ? (n - r + kLanes - 1) / kLanes : 0;
    const int first = k0 + r;
    const int trip = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(mine)));
    for (int t0 = 0; t0 < trip; t0 += 32) {
      const int m = min(32, mine - t0);  // this lane's steps in the window
      unsigned found = 0;
      for (int b = 0; b < m; b += walk::kBatch) {
        Rec<T> q[walk::kBatch];
#pragma unroll
        for (int u = 0; u < walk::kBatch; ++u)
          q[u] = pos(first + kLanes * (t0 + min(b + u, m - 1)));
#pragma unroll
        for (int u = 0; u < walk::kBatch; ++u)
          if (b + u < m && test(q[u])) found |= 1u << (b + u);
      }
      if (!__any_sync(kFull, found != 0)) continue;
      while (__any_sync(kFull, bits[0] != 0)) round(body);
#pragma unroll
      for (int w = 0; w + 1 < walk::kWindows; ++w) {
        bits[w] = bits[w + 1];
        base[w] = base[w + 1];
        tag[w] = tag[w + 1];
      }
      bits[walk::kWindows - 1] = found;
      base[walk::kWindows - 1] = first + kLanes * t0;
      tag[walk::kWindows - 1] = g;
    }
  }

  // Hand every held candidate to the body.
  template <class Body>
  __device__ __forceinline__ void finish(Body& body) {
    for (;;) {
      unsigned any = 0;
#pragma unroll
      for (int w = 0; w < walk::kWindows; ++w) any |= bits[w];
      if (!__any_sync(kFull, any != 0)) return;
      round(body);
    }
  }
};

// One source's stencil ranges for lane r of the group of the dest di in
// the lane's cell l, each walked as GroupWalker::walk with its wrap tag
// (0 on an open grid).  The caller finishes the walker after the source.
template <typename T, bool PERIODIC, class Body>
__device__ __forceinline__ void walk_source(const GasdArgs& a,
                                            const GasdSrc& S,
                                            const walk::Lane& l, int r,
                                            const Rec<T>& di, T rs,
                                            const walk::Box<T>& box,
                                            GroupWalker<T>& walker,
                                            Body& body) {
  const void* p0 = S.plane[kPos];
  auto load = [&](int k) { return rec<T>(p0, k); };
  if (!PERIODIC) {
    auto test = [&](const Rec<T>& q) {
      return in_support_rn<T, false>(di, q, rs, box, 0);
    };
    const int ry = a.ny > 1, rz = a.nz > 1;
    for (int oz = -rz; oz <= rz; ++oz) {
      for (int oy = -ry; oy <= ry; ++oy) {
        walk::Span sp{0, 0};
        if (l.active)
          sp = walk::row_span(a, S.cell_start, S.cell_end, l.cx - 1,
                              l.cx + 1, l.y + oy, l.z + oz);
        walker.walk(sp.k0, sp.k1 - sp.k0, r, 0, test, load, body);
      }
    }
    return;
  }
  int xlo, xhi, ylo, yhi, zlo, zhi;
  walk::axis_offsets(a.nx, box.len[0] != T(0), xlo, xhi);
  walk::axis_offsets(a.ny, box.len[1] != T(0), ylo, yhi);
  walk::axis_offsets(a.nz, box.len[2] != T(0), zlo, zhi);
  // a row y (or z) outside the grid is a wrapped one (on an axis that is
  // not periodic it is empty)
  auto wrap = [](int c, int n) { return c < 0 ? -1 : c >= n ? 1 : 0; };
  const int xa = l.cx + xlo, xb = l.cx + xhi;
  // the x wrap of the row's first range and of its second
  const int sx0 = box.len[0] != T(0) && xa < 0 ? -1 : 0;
  const int sx1 = xa < 0 ? 0 : 1;
  for (int oz = zlo; oz <= zhi; ++oz) {
    for (int oy = ylo; oy <= yhi; ++oy) {
      walk::Span first{0, 0}, second{0, 0};
      if (l.active)
        walk::periodic_row(a, S.cell_start, S.cell_end, xa, xb, l.y + oy,
                           l.z + oz, box, first, second);
      const int sy = wrap(l.y + oy, a.ny), sz = wrap(l.z + oz, a.nz);
      const int g0 = wrap_tag(sx0, sy, sz), g1 = wrap_tag(sx1, sy, sz);
      auto test0 = [&](const Rec<T>& q) {
        return in_support_rn<T, true>(di, q, rs, box, g0);
      };
      walker.walk(first.k0, first.k1 - first.k0, r, g0, test0, load, body);
      if (__any_sync(kFull, second.k1 > second.k0)) {
        auto test1 = [&](const Rec<T>& q) {
          return in_support_rn<T, true>(di, q, rs, box, g1);
        };
        walker.walk(second.k0, second.k1 - second.k0, r, g1, test1, load,
                    body);
      }
    }
  }
}

// The group's sum of v: a butterfly over its lanes, the same bits in each.
template <typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// SummationDensityADKE's loop: WIJ at the mean h, DWI at the dest's.
template <typename T, int KIND>
struct AdkeDensity {
  static constexpr bool kDensitySet = true;
  T ui = 0, vi = 0, wi = 0, hi = 0, kfac = 0;
  AtH<T, KIND> at{};
  int dim = 0;
  T rho = 0, arho = 0;
  __device__ void load(const GasdArgs& a, int i) {
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    hi = ld<T>(a.h, i);
    kfac = T(a.kfac);
    dim = a.dim;
    at.set(hi, kfac, dim);
  }
  __device__ void source(const GasdSrc&) {}
  __device__ void pair(const GasdSrc& S, const Pair<T>& q) {
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);  // u v w m
    AtH<T, KIND> atij;
    atij.set(T(0.5) * (hi + q.hj), kfac, dim);
    T w, dw;
    shapes::shape<T, KIND>(q.rij * atij.h1, w, dw);
    const T gi = at.grad(q);
    const T mj = vm.d;
    rho += mj * (w * atij.fac);
    const T vdot = (ui - vm.a) * (gi * q.xij) + (vi - vm.b) * (gi * q.yij) +
                   (wi - vm.c) * (gi * q.zij);
    arho += mj * vdot;
  }
  __device__ void reduce() {
    rho = group_sum(rho);
    arho = group_sum(arho);
  }
  __device__ void store(const GasdArgs& a, int i, bool wm) {
    const T acc[2] = {rho, arho};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const T pre = ld<T>(a.pre[oRho + k], i);
      static_cast<T*>(a.out[oRho + k])[i] = wm ? pre + acc[k] : pre;
    }
  }
};

// ADKEAccelerations' loop.
template <typename T, int KIND>
struct AdkeAccel {
  static constexpr bool kDensitySet = false;
  T ui = 0, vi = 0, wi = 0, hi = 0, rhoi = 0, csi = 0, ei = 0, divi = 0,
    pibrhoi2 = 0, kfac = 0;
  int dim = 0;
  // the source's constants and the dest's Hi under them
  T alpha = 0, beta = 0, Hi = 0;
  T au = 0, av = 0, aw = 0, ae = 0;
  __device__ void load(const GasdArgs& a, int i) {
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    hi = ld<T>(a.h, i);
    rhoi = ld<T>(a.rho, i);
    csi = ld<T>(a.cs, i);
    ei = ld<T>(a.e, i);
    divi = ld<T>(a.div, i);
    pibrhoi2 = ld<T>(a.p, i) / (rhoi * rhoi);
    kfac = T(a.kfac);
    dim = a.dim;
  }
  __device__ void source(const GasdSrc& S) {
    alpha = T(S.alpha);
    beta = T(S.beta);
    const T g1 = T(S.g1), g2 = T(S.g2);
    Hi = g1 * hi * csi + g2 * hi * hi * (fabs(divi) - divi);
  }
  __device__ void pair(const GasdSrc& S, const Pair<T>& q) {
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);     // u v w m
    const Rec<T> th = rec<T>(S.plane[kThermo], q.k);   // rho p cs e
    const Rec<T> sw = rec<T>(S.plane[kSwitch], q.k);
    const T mj = vm.d, rhoj = th.a, hj = q.hj;
    // pj / rhoj^2, Hj, 0, divj (adke_terms_kernel)
    const T pjbrhoj2 = sw.a, Hj = sw.b;
    const T cij = T(0.5) * (csi + th.c);
    const T eij = ei - th.d;
    const T hij = T(0.5) * (hi + hj);
    const T eps = T(0.01) * hij * hij;
    const T rhoij = T(0.5) * (rhoi + rhoj);
    const T rhoij1 = T(1) / (rhoij != T(0) ? rhoij : T(1));
    const T r2 = q.xij * q.xij + q.yij * q.yij + q.zij * q.zij;
    const T Hij = (Hi + Hj) * eij / (rhoij * (r2 + eps));
    const T vij[3] = {ui - vm.a, vi - vm.b, wi - vm.c};
    const T xv = q.xij * vij[0] + q.yij * vij[1] + q.zij * vij[2];
    const T muij = hij * xv / (r2 + eps);
    T piij = muij * (beta * muij - alpha * cij) * rhoij1;
    piij = xv < T(0) ? piij : T(0);
    const T tmpv = pibrhoi2 + pjbrhoj2 + piij;
    AtH<T, KIND> atij;
    atij.set(hij, kfac, dim);
    const T gij = atij.grad(q);
    const T dwij[3] = {gij * q.xij, gij * q.yij, gij * q.zij};
    au += -mj * tmpv * dwij[0];
    av += -mj * tmpv * dwij[1];
    aw += -mj * tmpv * dwij[2];
    const T vd = vij[0] * dwij[0] + vij[1] * dwij[1] + vij[2] * dwij[2];
    const T xd = q.xij * dwij[0] + q.yij * dwij[1] + q.zij * dwij[2];
    ae += T(0.5) * mj * (tmpv * vd + T(2) * xd * Hij);
  }
  __device__ void reduce() {
    au = group_sum(au);
    av = group_sum(av);
    aw = group_sum(aw);
    ae = group_sum(ae);
  }
  __device__ void store(const GasdArgs& a, int i, bool wm) {
    const T acc[4] = {au, av, aw, ae};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T pre = ld<T>(a.pre[oAu + k], i);
      static_cast<T*>(a.out[oAu + k])[i] = wm ? pre + acc[k] : pre;
    }
  }
};

// The blocks of kThreads an SM that a kernel's __launch_bounds__ asks for.
template <typename T, class Set>
constexpr int blocks_for() {
  return sizeof(T) == 8 ? ADKE_BLOCKS_F64
         : Set::kDensitySet ? ADKE_DENSITY_BLOCKS : ADKE_ACCEL_BLOCKS;
}

template <typename T, int KIND, bool PERIODIC, class Set>
__global__ void __launch_bounds__(kThreads, (blocks_for<T, Set>()))
    adke_pair_kernel(const GasdArgs a) {
  // every lane stays to the end: the walk's votes and the group's sums
  // take the whole warp
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int pos = t / kLanes, r = t % kLanes;
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
  const walk::Lane l = walk::lane_cell(a, active ? a.cell[i] : 0, active);
  GroupWalker<T> walker;
  walker.begin();
  int pairs = 0;
  for (int s = 0; s < a.n_src; ++s) {
    const GasdSrc& S = a.src[s];
    ph.source(S);
    const void* p0 = S.plane[kPos];
    auto body = [&](int k, int tag) {
      ++pairs;
      ph.pair(S, pair_at<T, PERIODIC>(di, rec<T>(p0, k), k, tag, box));
    };
    walk_source<T, PERIODIC>(a, S, l, r, di, rs, box, walker, body);
    walker.finish(body);
  }
  ph.reduce();
  pairs = group_sum(pairs);
  if (active && r == 0) {
    ph.store(a, i, a.wmask == nullptr || a.wmask[i] != 0);
    if (a.count != nullptr) a.count[i] = pairs;
  }
}

// AdkeAccel's per-source terms: plane 3 of each packed source, 0 0 0 div
// as packed, rewritten as pj / rhoj^2, Hj, 0, div in single IEEE
// operations in the order of the expressions (ops/gasd_pair.py
// adke_terms_reference).  Grid y: the source.
template <typename T>
__global__ void __launch_bounds__(256) adke_terms_kernel(const GasdArgs a) {
  const GasdSrc& S = a.src[blockIdx.y];
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= a.pack.src[blockIdx.y].n) return;
  const T hj = rec<T>(S.plane[kPos], k).d;
  const Rec<T> th = rec<T>(S.plane[kThermo], k);  // rho p cs e
  T* sw = static_cast<T*>(const_cast<void*>(S.plane[kSwitch]));
  const T div = sw[4 * static_cast<size_t>(k) + 3];  // written below
  const T g1 = T(S.g1), g2 = T(S.g2);
  const T pjbrhoj2 = div_rn(th.b, mul_rn(th.a, th.a));
  const T Hj = add_rn(mul_rn(mul_rn(g1, hj), th.c),
                      mul_rn(mul_rn(mul_rn(g2, hj), hj),
                             sub_rn(fabs(div), div)));
  pack::store(sw, k, pjbrhoj2, Hj, T(0), div);
}

template <typename T>
cudaError_t launch_terms(const GasdArgs& a, cudaStream_t stream) {
  int n = 0;
  for (int s = 0; s < a.n_src; ++s)
    n = a.pack.src[s].n > n ? a.pack.src[s].n : n;
  if (n == 0) return cudaSuccess;
  const dim3 blocks((n + 255) / 256, a.n_src);
  adke_terms_kernel<T><<<blocks, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND, bool PERIODIC>
cudaError_t launch_sets(const GasdArgs& a, cudaStream_t stream) {
  const long long threads = static_cast<long long>(a.n_dest) * kLanes;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  if (a.phase == kAdkeDensity)
    adke_pair_kernel<T, KIND, PERIODIC, AdkeDensity<T, KIND>>
        <<<blocks, kThreads, 0, stream>>>(a);
  else
    adke_pair_kernel<T, KIND, PERIODIC, AdkeAccel<T, KIND>>
        <<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const GasdArgs& a, cudaStream_t stream) {
  if (a.phase == kAdkeAccel) {
    const cudaError_t rc = launch_terms<T>(a, stream);
    if (rc != cudaSuccess) return rc;
  }
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    constexpr int K = decltype(kind)::value;
    return a.periodic ? launch_sets<T, K, true>(a, stream)
                      : launch_sets<T, K, false>(a, stream);
  });
}

bool args_ok(const GasdArgs& a) {
  const bool phase_ok = a.phase == kAdkeDensity || a.phase == kAdkeAccel;
  const bool density = a.phase == kAdkeDensity;
  bool sources_ok = a.n_src >= 1 && a.n_src <= kGasdSources;
  for (int s = 0; sources_ok && s < a.n_src; ++s) {
    const GasdSrc& S = a.src[s];
    sources_ok = S.terms == (density ? kAden : kAdke) &&
                 S.cell_start != nullptr && S.cell_end != nullptr;
    for (int q = 0; q < (density ? 2 : kGasdPlanes); ++q)
      sources_ok = sources_ok && S.plane[q] != nullptr;
  }
  bool outs_ok = true;
  for (int k = density ? oRho : oAu; k <= (density ? oArho : oAe); ++k)
    outs_ok = outs_ok && a.pre[k] != nullptr && a.out[k] != nullptr;
  return phase_ok && sources_ok && outs_ok && a.mode == kWalk &&
         a.nx >= 1 && a.ny >= 1 && a.nz >= 1 && a.dim >= 1 && a.dim <= 3 &&
         (a.dtype == 0 || a.dtype == 1) &&
         shapes::built_kind(a.kernel_kind) && a.dorder != nullptr &&
         a.cell != nullptr && pack::args_ok(a.pack) &&
         a.pack.dtype == a.dtype;
}

}  // namespace

extern "C" {

int adke_pair_args_size() { return static_cast<int>(sizeof(GasdArgs)); }

// the lanes of a dest's group this library was built with
int adke_pair_lanes() { return kLanes; }

int adke_pair_launch(const GasdArgs* args, void* stream) {
  const GasdArgs& a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                       : launch<double>(a, st));
}

const char* adke_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
