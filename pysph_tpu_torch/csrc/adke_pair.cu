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
//   Lanes.  A group of kLanes lanes takes a dest, each lane a stride of
//   every stencil range, the group's sums added by a __shfl_xor_sync
//   butterfly (csrc/group_walk.cuh), lane 0 storing them.  A launch gives
//   the same bits every time; the sums differ from the plain version's
//   order by rounding only.  The support test is in single IEEE
//   operations, so that the pairs and each dest's count are exactly the
//   plain version's although this library is built with FMA contraction
//   on (the pair bodies contract); on a periodic grid the image comes from
//   the stencil range's wrap where |d - L s| < L / 4, else the division
//   (csrc/group_walk.cuh).
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
#include "group_walk.cuh"
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
using walk::Rec;
using walk::rec;

constexpr int kLanes = ADKE_LANES;
constexpr int kThreads = 128;

using group::add_rn;
using group::div_rn;
using group::mul_rn;
using group::sub_rn;

template <typename T>
__device__ __forceinline__ T group_sum(T v) {
  return group::sum<kLanes>(v);
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
  group::Walker<T, kLanes> walker;
  walker.begin();
  group::NoList nolist;
  int pairs = 0;
  for (int s = 0; s < a.n_src; ++s) {
    const GasdSrc& S = a.src[s];
    ph.source(S);
    const void* p0 = S.plane[kPos];
    auto body = [&](int k, int tag) {
      ++pairs;
      ph.pair(S, group::pair_at<Pair<T>, T, PERIODIC>(di, rec<T>(p0, k), k,
                                                      tag, box));
    };
    group::walk_source<T, kLanes, PERIODIC>(a, S.cell_start, S.cell_end, p0,
                                            l, r, di, rs, box, walker, body,
                                            nolist);
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
