// Gas-dynamics pair kernel for Hopper (sm_90a): GasDScheme's grad-h MPM
// pair terms with per-particle smoothing lengths, over the warp-coherent
// walk of csrc/cell_walk.cuh and the cell-sorted packed sources of
// csrc/cell_pack.cuh, on an open or a periodic grid.
//
// Replaces pysph_tpu/ops/pallas_engine.py::_pair_kernel_compact (:1160,
// its pallas_call :1867), which the TPU runs for both MPM pair phases of
// GasDScheme (the shock tube and the Sedov blast of
// examples/gas_dynamics/), and for ADKEScheme's two, which
// csrc/adke_pair.cu runs here (the arguments of both are
// csrc/gasd_terms.cuh's): the resident engine turns itself off for an
// update_nnps group.  Two phase sets, one device functor each:
//
//   Density       SummationDensity: WI, DWI and GHI at the dest's h
//                 -> rho arho grhox grhoy grhoz dwdh
//   Momentum      MPMAccelerations: DWI at the dest's h, DWJ at the
//                 source's, DWIJ at HIJ; the signal-velocity viscosity
//                 (dot <= 0) and conduction; a MAX into dt_cfl
//                 -> au av aw ae del2e dt_cfl
//
// h varies per particle: the walk's support test is r2 < (rs max(hi,
// hj))^2 (walk::in_support), so a pair in support through hj only adds the
// kernel's zero at hi, as the torch pair engine's.  The shape is any kind
// of csrc/shapes.cuh (the Gaussian, kind 2, radius scale 3, is the
// scheme's default), a template parameter: this library holds kinds 0-3
// and each later kind is a library of its own (shapes::with_kind,
// ops/build.py kind_flags); GHI is shapes::gradient_h.  MPMAccelerations'
// normalised XIJ is a copy inside the pair body.  One launch computes the
// pair terms of one dest array over all its sources (at most 4) and
// writes each output once: pre + sum (dt_cfl: max(pre, max over pairs))
// under the write mask, pre elsewhere; with a non-null count, each dest's
// number of pairs in support.
//
// Design, as csrc/iisph_pair.cu's walk: thread t takes the dest at
// position t of the dest's sorted order, so a warp holds dests of one or
// a few nearby cells; each lane walks its own cells cx - 1 .. cx + 1 in
// each stencil row (on a periodic grid, the template flag PERIODIC, the
// rows wrap and each displacement is the minimum image,
// walk::walk_rows_periodic); the walker hands the candidates in support
// to the pair body in rounds, one per lane.  Each source is read from its
// packed copy (launched by this file's launch function just before the
// kernel), whose record planes are, as ops/gasd_pair.py PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: u v w m
//   plane 2: rho p cs e
//   plane 3: omega alpha1 alpha2 div
// of which the density set packs planes 0 and 1, the momentum set all
// four (div written 0).  No shared memory: every run sums in the order of
// the plain stencil walk.  Built with -fmad=false (ops/build.py EXTRA_FLAGS): the
// support test then rounds each operation as the plain version's, so the
// pairs and each dest's count are exactly its.
//
// Modes (the template flag MODE).  kWalk: the call above (the tools'
// unlinked calls).  kSweep, the density set only: one sweep of
// GasDScheme's iterated density group (ops/gasd_pair.py gasd_sweep), all
// gated by the 0-d flag run (null: runs; where 0 the pack and the kernel
// return at once and nothing is written): the pack, SummationDensity's
// initialize (the sums start at 0 under the write mask), its pair sums,
// its post_loop (the Newton step of h towards rho = m (k / h)^dim for
// each particle not yet converged, omega, arho, ah, converged and div;
// in IEEE operations as the torch post_loop's) written in place of the
// dest's props (each dest reads its own h before it writes it: the walk
// reads the sources from the packed snapshot), and the count of the
// particles not converged after it (warp-aggregated atomics, an integer:
// deterministic); and it emits its neighbour list: entry c of the dest at
// sorted position p is nbr[c * n_dest + p], source s's position k
// numbered base_s + k, for c < cap, lcount[p] its pairs (which may exceed
// cap: each such dest adds one to *overflow).  Positions do not move
// during the iteration and a sweep that ends it converged leaves every h
// as it was, so the last sweep's list holds the momentum launch's pairs,
// in its walk's order.  kConsume, the momentum set only: where the 0-d
// flag use is set (the iteration ended converged, decided on the card)
// its pack skips plane 0 and the kernel reads {x y z h} from the last
// sweep's copy (hplane) and a warp whose dests all fit reads their listed
// pairs in list order, handing each to the same pair_of and functor as
// the walk, so its sums are the walk's bit for bit; a warp with a dest
// past cap walks (on that copy).  Where use is 0 (the iteration ended at
// max_iterations, so h moved in its last sweep) it packs all four planes
// and walks, as kWalk.
//
// What bounds it: operations.  A launch tests the candidates of the
// stencil (a 16-byte record load and a support test each); per pair in
// support the density set evaluates the kernel's shape once (an exp for
// the Gaussian) and ~30 flops on two records, the momentum set the
// kernel's gradient at three smoothing lengths (three shapes) and ~110
// flops on four records.  With
// cells sized by hmax, a dest whose h is small tests up to (hmax /
// hi)^dim times the candidates it needs; the grid is not stratified
// (ROADMAP Queue 1 item 27).  The bytes are a few records a particle.
//
// Interface: plain C, called through ctypes (ops/gasd_pair.py).  The
// launch function takes a host pointer to GasdArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack and
// then the kernel, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "gasd_terms.cuh"
#include "shapes.cuh"

namespace {

using gasd::AtH;
using gasd::hpow;
using gasd::ld;
using gasd::Pair;
using walk::Rec;
using walk::rec;

// x^(1 / dim) as torch's pow takes it: x, sqrt, pow
__device__ __forceinline__ float root(float x, int dim) {
  return dim == 1 ? x : dim == 2 ? sqrtf(x) : powf(x, 1.0f / 3.0f);
}
__device__ __forceinline__ double root(double x, int dim) {
  return dim == 1 ? x : dim == 2 ? sqrt(x) : pow(x, 1.0 / 3.0);
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

// SummationDensity: WI, DWI, GHI at the dest's h.
template <typename T, int KIND>
struct Density {
  static constexpr bool kDensitySet = true;
  T ui = 0, vi = 0, wi = 0;
  AtH<T, KIND> at{};
  int dim = 0;
  T rho = 0, arho = 0, gx = 0, gy = 0, gz = 0, dwdh = 0;
  __device__ void load(const GasdArgs& a, int i) {
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    dim = a.dim;
    at.set(ld<T>(a.h, i), T(a.kfac), dim);
  }
  __device__ void pair(const GasdSrc& S, const Pair<T>& q) {
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);  // u v w m
    const T qi = q.rij * at.h1;
    T w, dw;
    shapes::shape<T, KIND>(qi, w, dw);
    const T gr = q.rij > T(1e-12) ? dw * at.fac * at.h1 * q.rinv : T(0);
    const T dx = gr * q.xij, dy = gr * q.yij, dz = gr * q.zij;
    const T mj = vm.d;
    const T vdot = (ui - vm.a) * dx + (vi - vm.b) * dy + (wi - vm.c) * dz;
    rho += mj * (w * at.fac);
    arho += mj * vdot;
    gx += mj * dx;
    gy += mj * dy;
    gz += mj * dz;
    dwdh += mj * shapes::gradient_h(w, dw, qi, at.fac, at.h1, dim);
  }
  __device__ void store(const GasdArgs& a, int i, bool wm) {
    const T acc[6] = {rho, arho, gx, gy, gz, dwdh};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const T pre = ld<T>(a.pre[oRho + k], i);
      static_cast<T*>(a.out[oRho + k])[i] = wm ? pre + acc[k] : pre;
    }
  }
  // kSweep: initialize, the sums and post_loop of SummationDensity, in
  // place of the dest's props (hi: its h, read before the walk); returns
  // whether the particle is converged after it
  __device__ bool sweep(const GasdArgs& a, int i, bool wm, T hi) {
    T v[kSweepOut];
#pragma unroll
    for (int k = 0; k < kSweepOut; ++k) v[k] = ld<T>(a.swpre[k], i);
    if (wm) {
      // initialize zeroes the sums (and div), the pair phase adds
      v[wRho] = T(0) + rho;
      v[wArho] = T(0) + arho;
      v[wGrhox] = T(0) + gx;
      v[wGrhoy] = T(0) + gy;
      v[wGrhoz] = T(0) + gz;
      v[wDwdh] = T(0) + dwdh;
      v[wDiv] = T(0);
      if (a.density_iterations) post_loop(a, i, hi, v);
      v[wDiv] = -v[wArho] / v[wRho];
    }
#pragma unroll
    for (int k = 0; k < kSweepOut; ++k) static_cast<T*>(a.sw[k])[i] = v[k];
    return v[wConverged] == T(1);
  }
  // SummationDensity.post_loop with density_iterations, as its torch ops
  __device__ void post_loop(const GasdArgs& a, int i, T hi, T* v) {
    const bool act = v[wConverged] != T(1);
    const T mi = ld<T>(a.m, i), hi0 = ld<T>(a.h0, i);
    const T kk = T(a.k), r = v[wRho];
    const T rhoi = mi / hpow(hi / kk, dim);
    const T dhdrhoi = -hi / (T(dim) * r);
    T omegai = T(1) - dhdrhoi * v[wDwdh];
    omegai = omegai < T(0) ? T(1) : omegai;
    const T gradhi = T(1) / omegai;
    const T func = rhoi - r;
    const T dfdh = omegai / dhdrhoi;
    T hnew = hi - func / dfdh;
    hnew = tmin(tmax(hnew, T(0.8) * hi), T(1.2) * hi);
    if (hnew <= T(1e-6) || gradhi < T(1e-6)) hnew = kk * root(mi / r, dim);
    const T diff = fabs(hnew - hi) / hi0;
    const bool done =
        a.iterate_once != 0 || (diff < T(a.htol) && omegai > T(0));
    if (act) v[wOmega] = gradhi;
    v[wH] = act && !done ? hnew : hi;
    if (act && done) {
      v[wArho] = v[wArho] * gradhi;
      v[wAh] = v[wArho] * dhdrhoi;
    }
    v[wConverged] = act && done ? T(1) : act ? T(0) : v[wConverged];
  }
};

// MPMAccelerations' loop.
template <typename T, int KIND>
struct Momentum {
  static constexpr bool kDensitySet = false;
  T ui = 0, vi = 0, wi = 0, hi = 0, rhoi = 0, p_i = 0, csi = 0, ei = 0,
    omegai = 0, a1i = 0, a2i = 0, pibrhoi2 = 0, kfac = 0;
  AtH<T, KIND> at{};
  int dim = 0;
  T au = 0, av = 0, aw = 0, ae = 0, del2e = 0, cfl = 0;
  __device__ void load(const GasdArgs& a, int i) {
    ui = ld<T>(a.u, i);
    vi = ld<T>(a.v, i);
    wi = ld<T>(a.w, i);
    hi = ld<T>(a.h, i);
    rhoi = ld<T>(a.rho, i);
    p_i = ld<T>(a.p, i);
    csi = ld<T>(a.cs, i);
    ei = ld<T>(a.e, i);
    omegai = ld<T>(a.omega, i);
    a1i = ld<T>(a.alpha1, i);
    a2i = ld<T>(a.alpha2, i);
    pibrhoi2 = p_i / (rhoi * rhoi);
    kfac = T(a.kfac);
    dim = a.dim;
    at.set(hi, kfac, dim);
    cfl = ld<T>(a.pre[oDtCfl], i);
  }
  __device__ void pair(const GasdSrc& S, const Pair<T>& q) {
    const Rec<T> vm = rec<T>(S.plane[kVelM], q.k);     // u v w m
    const Rec<T> th = rec<T>(S.plane[kThermo], q.k);   // rho p cs e
    const Rec<T> sw = rec<T>(S.plane[kSwitch], q.k);   // omega a1 a2 0
    const T beta = T(S.beta);
    const T mj = vm.d, rhoj = th.a, pj = th.b;
    const T pjbrhoj2 = pj / (rhoj * rhoj);
    const T cij = T(0.5) * (csi + th.c);
    const T rhoij = T(0.5) * (rhoi + rhoj);
    const T hij = T(0.5) * (hi + q.hj);
    const T eps = T(0.01) * hij * hij;
    // DWI, DWJ and DWIJ: the gradient at the dest's, the source's and
    // their mean smoothing length
    AtH<T, KIND> atj, atij;
    atj.set(q.hj, kfac, dim);
    atij.set(hij, kfac, dim);
    const T gi = at.grad(q), gj = atj.grad(q), gij = atij.grad(q);
    const T dwi[3] = {gi * q.xij, gi * q.yij, gi * q.zij};
    const T dwj[3] = {gj * q.xij, gj * q.yij, gj * q.zij};
    const T dwij[3] = {gij * q.xij, gij * q.yij, gij * q.zij};
    const T vij[3] = {ui - vm.a, vi - vm.b, wi - vm.c};
    // the normalised interaction vector, a copy of XIJ
    const bool near = q.rij < T(1e-8);
    const T safe_r = near ? T(1) : q.rij;
    const T xn[3] = {near ? T(0) : q.xij / safe_r,
                     near ? T(0) : q.yij / safe_r,
                     near ? T(0) : q.zij / safe_r};
    const T dot = vij[0] * xn[0] + vij[1] * xn[1] + vij[2] * xn[2];
    const T fij = xn[0] * dwij[0] + xn[1] * dwij[1] + xn[2] * dwij[2];
    const T pdiff = fabs(p_i - pj);
    const T s1 = T(2) * cij - beta * dot;
    const T vsig1 = T(0.5) * (s1 > T(0) ? s1 : T(0));
    const T vsig2 = sqrt(pdiff / rhoij);
    const T sig = cij + beta * dot;
    cfl = sig > cfl ? sig : cfl;
    const T alpha1 = T(0.5) * (a1i + sw.b);
    if (dot <= T(0)) {
      const T visc = mj / rhoij * alpha1 * vsig1 * dot;
      au += visc * dwij[0];
      av += visc * dwij[1];
      aw += visc * dwij[2];
      ae += T(-0.5) * mj / rhoij * alpha1 * vsig1 * dot * dot * fij;
    }
    const T omegaj = sw.a;
    au += -mj * (pibrhoi2 * omegai * dwi[0] + pjbrhoj2 * omegaj * dwj[0]);
    av += -mj * (pibrhoi2 * omegai * dwi[1] + pjbrhoj2 * omegaj * dwj[1]);
    aw += -mj * (pibrhoi2 * omegai * dwi[2] + pjbrhoj2 * omegaj * dwj[2]);
    const T vdotdwi = vij[0] * dwi[0] + vij[1] * dwi[1] + vij[2] * dwi[2];
    ae += mj * pibrhoi2 * omegai * vdotdwi;
    const T alpha2 = T(0.5) * (a2i + sw.c);
    const T eij = ei - th.d;
    ae += mj / rhoij * alpha2 * vsig2 * eij * fij;
    del2e += mj / rhoj * eij / (q.rij + eps) * fij;
  }
  __device__ void store(const GasdArgs& a, int i, bool wm) {
    const T acc[5] = {au, av, aw, ae, del2e};
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const T pre = ld<T>(a.pre[oAu + k], i);
      static_cast<T*>(a.out[oAu + k])[i] = wm ? pre + acc[k] : pre;
    }
    const T pre = ld<T>(a.pre[oDtCfl], i);
    static_cast<T*>(a.out[oDtCfl])[i] = wm ? cfl : pre;
  }
};

// kSweep's store: the density set's sweep (the other sets never sweep)
template <typename T, int KIND>
__device__ __forceinline__ bool sweep_of(Density<T, KIND>& ph,
                                         const GasdArgs& a, int i, bool wm,
                                         T hi) {
  return ph.sweep(a, i, wm, hi);
}
template <class PhaseSet, typename T>
__device__ __forceinline__ bool sweep_of(PhaseSet&, const GasdArgs&, int,
                                         bool, T) {
  return true;
}

// The blocks of 128 threads an SM that a kernel's __launch_bounds__ asks
// for: double 4; float 8 for the density set, 6 for the momentum set.
template <typename T, class PhaseSet>
constexpr int blocks_for() {
  return sizeof(T) == 8 ? 4 : PhaseSet::kDensitySet ? 8 : 6;
}

template <typename T, int KIND, bool PERIODIC, class PhaseSet, int MODE>
__global__ void __launch_bounds__(128, (blocks_for<T, PhaseSet>()))
    gasd_pair_kernel(const GasdArgs a) {
  if (MODE == kSweep && a.run != nullptr && *a.run == 0) return;
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
        const GasdSrc& S = a.src[from[u]];
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
      const GasdSrc& S = a.src[s];
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

constexpr int kThreads = 128;

template <typename T, int KIND, bool PERIODIC>
cudaError_t launch_walk(const GasdArgs& a, cudaStream_t stream) {
  using D = Density<T, KIND>;
  using M = Momentum<T, KIND>;
  const int blocks = (a.n_dest + kThreads - 1) / kThreads;
  if (a.mode == kSweep)
    gasd_pair_kernel<T, KIND, PERIODIC, D, kSweep>
        <<<blocks, kThreads, 0, stream>>>(a);
  else if (a.mode == kConsume)
    gasd_pair_kernel<T, KIND, PERIODIC, M, kConsume>
        <<<blocks, kThreads, 0, stream>>>(a);
  else if (a.phase == kDensity)
    gasd_pair_kernel<T, KIND, PERIODIC, D, kWalk>
        <<<blocks, kThreads, 0, stream>>>(a);
  else
    gasd_pair_kernel<T, KIND, PERIODIC, M, kWalk>
        <<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_kind(const GasdArgs& a, cudaStream_t stream) {
  return a.periodic ? launch_walk<T, KIND, true>(a, stream)
                    : launch_walk<T, KIND, false>(a, stream);
}

template <typename T>
cudaError_t launch(const GasdArgs& a, cudaStream_t stream) {
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    return launch_kind<T, decltype(kind)::value>(a, stream);
  });
}

// the planes each set reads (ops/gasd_pair.py pack_layout)
int planes_of(int phase) { return phase == kDensity ? 2 : kGasdPlanes; }

// each set's outputs: [first, last] of GasdOut
void outputs_of(int phase, int& first, int& last) {
  first = phase == kDensity ? oRho : oAu;
  last = phase == kDensity ? oDwdh : oDtCfl;
}

// the ADKE sets are csrc/adke_pair.cu's
bool args_ok(const GasdArgs& a) {
  const bool phase_ok = a.phase == kDensity || a.phase == kMomentum;
  const int set_terms = a.phase == kDensity ? kSden : kMpm;
  bool sources_ok = a.n_src >= 1 && a.n_src <= kGasdSources;
  for (int s = 0; sources_ok && s < a.n_src; ++s) {
    const GasdSrc& S = a.src[s];
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
    outs_ok = outs_ok && a.phase == kDensity && a.m != nullptr &&
              a.h0 != nullptr && a.unconv != nullptr &&
              a.overflow != nullptr;
  } else {
    for (int k = first; k <= last; ++k)
      outs_ok = outs_ok && a.pre[k] != nullptr && a.out[k] != nullptr;
  }
  if (a.mode == kConsume) {
    outs_ok = outs_ok && a.phase == kMomentum && a.use != nullptr;
    for (int s = 0; s < a.n_src; ++s)
      outs_ok = outs_ok && a.hplane[s] != nullptr;
  }
  const bool list_ok =
      a.mode == kWalk ||
      (a.cap >= 1 && a.nbr != nullptr && a.lcount != nullptr);
  return sources_ok && outs_ok && list_ok &&
         (a.mode == kWalk || a.mode == kSweep || a.mode == kConsume) && a.nx >= 1 && a.ny >= 1 && a.nz >= 1 &&
         a.dim >= 1 && a.dim <= 3 && (a.dtype == 0 || a.dtype == 1) &&
         shapes::built_kind(a.kernel_kind) &&
         phase_ok &&
         a.dorder != nullptr && a.cell != nullptr &&
         pack::args_ok(a.pack) && a.pack.dtype == a.dtype;
}

}  // namespace

extern "C" {

int gasd_pair_args_size() { return static_cast<int>(sizeof(GasdArgs)); }

int gasd_pair_launch(const GasdArgs* args, void* stream) {
  GasdArgs a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the sweep's pack runs under its gate; the momentum launch that reads
  // the last sweep's copy leaves plane 0 unpacked
  a.pack.run = a.mode == kSweep ? a.run : nullptr;
  a.pack.skip0 = a.mode == kConsume ? a.use : nullptr;
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                       : launch<double>(a, st));
}

const char* gasd_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
