// The delta-SPH pre-phases for Hopper (sm_90a): the moment matrix of the
// Bonet-Lok gradient correction, and the corrected density gradient, on
// the warp-coherent walk over the cell-sorted packed sources.
//
// Replaces pysph_tpu/ops/resident.py::_pair_kernel_resident for the two
// groups that WCSPHScheme(delta_sph=True) puts before the main group:
//   MMAT        GradientCorrectionPreStep(dim): m_mat[3a+b] +=
//               -V_j DWIJ[a] XIJ[b], a, b < dim (a stride-9 output);
//   CORR | GRAD GradientCorrection(dim, tol) rewrites DWIJ pair by pair
//               from the dest's m_mat (the closed-form adjugate solve of
//               sph/wc/linalg.py small_solve_cols, kept where the L1 norm
//               changes by less than tol), then
//               ContinuityEquationDeltaSPHPreStep sums gradrho +=
//               (rho_j - rho_i) V_j DWIJ (a stride-3 output);
//   GRAD        the same sum on the uncorrected DWIJ.
// One launch is one group of one dest array over all of its sources (at
// most 4, all with the same terms); the moment group writes every row,
// the gradient group only the rows under the write mask, so the two are
// two launches.  The correction reads only the dest's own m_mat.
//
// The accept test is a step function: a pair whose change lies near tol
// flips between the corrected and the uncorrected gradient.  So DWIJ, the
// solve and the test are evaluated in the operations and the order of
// the plain version (the torch pair engine: sph/acceleration_eval.py
// PairContext, base/kernels.py, sph/wc/kernel_correction.py accept),
// with rsqrt for RINV as torch.rsqrt, and this file is built without FMA
// contraction (ops/build.py), so that on the same inputs both take the
// same decision.  The adjugate's cofactors and det depend on the dest
// alone: they are computed once a dest, before its pairs, in the same
// operations.  A singular matrix (|det| <= 1e-30) keeps the gradient,
// as the plain version does; `accepted` (optional) counts the accepted
// pairs of each dest.
//
// The walk is wcsph_pair's (csrc/cell_walk.cuh): thread = position in the
// dest's sorted order, each lane walking its cells cx - 1 .. cx + 1 in
// each stencil row of the packed copy, the candidates in support handed
// to the pair body in rounds.  On a periodic grid (the template flag
// PERIODIC: the Taylor-Green vortex's --delta-sph) the rows wrap
// (walk::walk_rows_periodic) and every displacement, in the support test
// and in the pair, is the minimum image d - L rint(d / L), rounded as the
// plain version's grid.image (torch.round; no FMA here either), so that
// the accept test sees the same XIJ.  Sources are read from their packed copy
// (csrc/cell_pack.cuh), whose record planes are, as ops/delta_pair.py
// PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: m rho 0 0
// Each dest sums in registers in the order of the plain stencil walk and
// writes its row once: no shared memory, no atomics.
//
// The linked pair (mode).  Between the two groups nothing moves x y z h m
// rho, so the gradient launch would find the moment launch's pairs again,
// in the same order.  kWalk walks (an unlinked call).  kEmit (the moment
// group) walks and also writes each dest's in-support candidates, in the
// order the body takes them, into the neighbour list: entry c of the dest
// at sorted position p is nbr[c * n_dest + p], a position in the
// numbering of all sources' copies (source s's position k is base_s + k),
// for c < cap; count[p] is the dest's number of pairs, which may exceed
// cap, and each such dest adds one to *overflow.  kConsume (the gradient
// group) packs nothing and reads the moment launch's copies: a warp whose
// dests all fit reads its lanes' listed records in list order, the plain
// walk's order, so its sums are those of the walk bit for bit; a warp
// with a dest past cap walks as kWalk.
//
// What bounds it: operations, ~1.97e9 flops for the two launches of an
// eval at dam_break_3d dx=0.02 (tools_dev/roofline.py delta_work), with
// no FMA to halve them.  A walking launch's time is mostly the walk's
// record loads and support tests, ~549 candidates a dest for ~75 pairs,
// so a linked pair walks once.
//
// Interface: plain C through ctypes (ops/delta_pair.py): the launch
// function takes a host pointer to DeltaArgs and the stream, launches the
// pack of a.pack (none where a.pack.n_src is 0) and then the kernel, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "wcsph_terms.cuh"

constexpr int kDeltaSources = 4;
constexpr int kMmat = 1, kCorr = 2, kGrad = 4;
constexpr int kWalk = 0, kEmit = 1, kConsume = 2;
// kConsume: listed entries whose loads a lane has in flight
// (tools_dev/list_batch.py times 1, 2, 4 and 8)
#ifndef LIST_BATCH
#define LIST_BATCH 2
#endif
constexpr int kListBatch = LIST_BATCH;

struct DeltaSrc {
  const void* pos;   // {x, y, z, h}
  const void* mass;  // {m, rho, 0, 0}
  const int32_t* cell_start;
  const int32_t* cell_end;
  int32_t base;  // its position 0 in the neighbour list's numbering
  int32_t pad;
};

struct DeltaArgs {
  const void *x, *y, *z, *h, *rho;  // dest
  const void* m_mat;  // dest, (n, 9): the correction's matrix (kCorr)
  const int32_t* cell;
  const int32_t *dorder, *dcell_start, *dcell_end;
  const uint8_t* wmask;  // null: every row
  const void* pre;  // (n, 9) m_mat (kMmat) or (n, 3) gradrho
  void* out;
  int32_t* accepted;  // per dest: pairs whose correction was kept; null
  // kEmit writes, kConsume reads: (cap, n_dest) entries, (n_dest) counts
  int32_t* nbr;
  int32_t* count;
  int32_t* overflow;  // kEmit: one per dest with more than cap pairs
  DeltaSrc src[kDeltaSources];
  double radius_scale, kfac, tol;
  double box[3];  // the length of each periodic axis, 0 on the others
  // dim: the kernel's; mdim: the moment's (kMmat) or correction's (kCorr)
  int32_t n_dest, n_src, nx, ny, nz, dim, kernel_kind, dtype, terms, mdim;
  int32_t mode, cap, periodic;
  PackArgs pack;
};

namespace {

template <typename T>
__device__ __forceinline__ T ld(const void* p, size_t i) {
  return static_cast<const T*>(p)[i];
}

// rsqrt as torch.rsqrt computes it on the card
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// sph/wc/linalg.py small_solve_cols for n = 1, 2, 3 on the matrix m
// (row-major 3x3, its top-left n x n block), in its operations and order,
// split in two: Solve holds what depends on m alone (det and, for n = 3,
// the cofactors), solve() replaces w by the solution unless |det| <=
// 1e-30.
template <typename T>
struct Solve {
  T c[9];  // n = 3: cofactor c_rc at c[3r + c]; n = 2: m itself
  T det;
  bool ok;
};

template <typename T>
__device__ __forceinline__ Solve<T> prepare_solve(const T* m, int n) {
  Solve<T> s;
  if (n == 1) {
    s.det = m[0];
  } else if (n == 2) {
#pragma unroll
    for (int e = 0; e < 9; ++e) s.c[e] = m[e];
    s.det = m[0] * m[4] - m[1] * m[3];
  } else {
    s.c[0] = m[4] * m[8] - m[5] * m[7];
    s.c[1] = -(m[3] * m[8] - m[5] * m[6]);
    s.c[2] = m[3] * m[7] - m[4] * m[6];
    s.c[3] = -(m[1] * m[8] - m[2] * m[7]);
    s.c[4] = m[0] * m[8] - m[2] * m[6];
    s.c[5] = -(m[0] * m[7] - m[1] * m[6]);
    s.c[6] = m[1] * m[5] - m[2] * m[4];
    s.c[7] = -(m[0] * m[5] - m[2] * m[3]);
    s.c[8] = m[0] * m[4] - m[1] * m[3];
    s.det = m[0] * s.c[0] + m[1] * s.c[1] + m[2] * s.c[2];
  }
  s.ok = fabs(s.det) > T(1e-30);
  return s;
}

template <typename T>
__device__ __forceinline__ void solve(const Solve<T>& s, T* w, int n) {
  if (!s.ok) return;
  const T* c = s.c;
  if (n == 1) {
    w[0] = w[0] / s.det;
  } else if (n == 2) {
    const T x0 = (c[4] * w[0] - c[1] * w[1]) / s.det;
    const T x1 = (c[0] * w[1] - c[3] * w[0]) / s.det;
    w[0] = x0;
    w[1] = x1;
  } else {
    const T x0 = (c[0] * w[0] + c[3] * w[1] + c[6] * w[2]) / s.det;
    const T x1 = (c[1] * w[0] + c[4] * w[1] + c[7] * w[2]) / s.det;
    const T x2 = (c[2] * w[0] + c[5] * w[1] + c[8] * w[2]) / s.det;
    w[0] = x0;
    w[1] = x1;
    w[2] = x2;
  }
}

template <typename T, int KIND, int MODE, bool MOMENT, bool PERIODIC>
__global__ void __launch_bounds__(128, sizeof(T) == 4 ? 8 : 4)
    delta_pair_kernel(const DeltaArgs a) {
  // every lane stays to the end: the walk's votes take the whole warp
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pos < a.n_dest;
  const int i = active ? a.dorder[pos] : 0;

  T xi = 0, yi = 0, zi = 0, hi = 0, rhoi = 0;
  const int n = a.mdim;
  const bool corr = a.terms & kCorr;
  T m[9] = {};
  if (active) {
    xi = ld<T>(a.x, i);
    yi = ld<T>(a.y, i);
    zi = ld<T>(a.z, i);
    hi = ld<T>(a.h, i);
    if (!MOMENT) rhoi = ld<T>(a.rho, i);
    if (!MOMENT && corr) {
#pragma unroll
      for (int e = 0; e < 9; ++e) m[e] = ld<T>(a.m_mat, 9 * size_t(i) + e);
    }
  }
  const Solve<T> sv = prepare_solve(m, n);  // the correction's (kCorr)
  const T rs = T(a.radius_scale), kfac = T(a.kfac), tol = T(a.tol);
  const walk::Box<T> box{{T(a.box[0]), T(a.box[1]), T(a.box[2])}};
  T acc[9] = {};
  int kept = 0, listed = 0;

  // the pair of this dest and the source particle whose records are p
  // ({x, y, z, h}) and mr ({m, rho, 0, 0})
  auto pair = [&](const walk::Rec<T>& p, const walk::Rec<T>& mr) {
    T xij = xi - p.a, yij = yi - p.b, zij = zi - p.c;
    if (PERIODIC) {
      xij = walk::image(xij, box.len[0]);
      yij = walk::image(yij, box.len[1]);
      zij = walk::image(zij, box.len[2]);
    }
    const T r2 = xij * xij + yij * yij + zij * zij;
    const T hij = T(0.5) * (hi + p.d);
    const T rinv = r2 > T(1e-24) ? rsqrt_t(r2) : T(0);
    const T rij = r2 * rinv;
    const T h1 = T(1) / (hij > T(0) ? hij : T(1));
    T wq, dwq;
    wcsph::shape<T, KIND>(rij * h1, wq, dwq);
    const T fac = kfac * (a.dim == 1   ? h1
                          : a.dim == 2 ? h1 * h1
                                       : h1 * h1 * h1);
    const T g = rij > T(1e-12) ? dwq * fac * h1 * rinv : T(0);
    T dw[3] = {g * xij, g * yij, g * zij};
    const T mj = mr.a, rhoj = mr.b;
    // loops over the 3 components with a test against n, unrolled, so
    // that every array stays in registers
    if (MOMENT) {
      const T x[3] = {xij, yij, zij};
      const T v = mj / rhoj;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (r < n && c < n) acc[3 * r + c] += -v * dw[r] * x[c];
      return;
    }
    if (corr) {
      T res[3] = {dw[0], dw[1], dw[2]};
      solve(sv, res, n);
      T res_mag = fabs(res[0]), dw_mag = fabs(dw[0]);
#pragma unroll
      for (int c = 1; c < 3; ++c) {
        if (c < n) {
          res_mag = res_mag + fabs(res[c]);
          dw_mag = dw_mag + fabs(dw[c]);
        }
      }
      const T eps = T(1.0e-4) * hij;
      const T change = fabs(res_mag - dw_mag) / (dw_mag + eps);
      if (change < tol) {
        ++kept;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (c < n) dw[c] = res[c];
      }
    }
    const T drho = (rhoj - rhoi) * mj / rhoj;
    acc[0] += drho * dw[0];
    acc[1] += drho * dw[1];
    acc[2] += drho * dw[2];
  };

  bool walking = true;
  if (MODE == kConsume) {
    const int count = active ? a.count[pos] : 0;
    walking = __any_sync(walk::kFull, count > a.cap);
    // kListBatch entries' loads in flight, then their pairs in order
    for (int c0 = 0; !walking && c0 < count; c0 += kListBatch) {
      int e[kListBatch];
#pragma unroll
      for (int u = 0; u < kListBatch; ++u)
        e[u] = c0 + u < count ? a.nbr[size_t(c0 + u) * a.n_dest + pos] : -1;
      walk::Rec<T> p[kListBatch], mr[kListBatch];
#pragma unroll
      for (int u = 0; u < kListBatch; ++u) {
        if (e[u] < 0) continue;
        // the source whose numbering holds e: the last with base <= e
        const void* pp = a.src[0].pos;
        const void* mp = a.src[0].mass;
        int base = 0;
#pragma unroll
        for (int s = 1; s < kDeltaSources; ++s) {
          if (s < a.n_src && e[u] >= a.src[s].base) {
            pp = a.src[s].pos;
            mp = a.src[s].mass;
            base = a.src[s].base;
          }
        }
        p[u] = walk::rec<T>(pp, e[u] - base);
        mr[u] = walk::rec<T>(mp, e[u] - base);
      }
#pragma unroll
      for (int u = 0; u < kListBatch; ++u)
        if (e[u] >= 0) pair(p[u], mr[u]);
    }
  }
  if (walking) {
    const walk::Lane l = walk::lane_cell(a, active ? a.cell[i] : 0, active);
    walk::Walker<T> walker;
    walker.begin();
    for (int s = 0; s < a.n_src; ++s) {
      const DeltaSrc& S = a.src[s];
      auto body = [&](int k) {
        if (MODE == kEmit) {
          if (listed < a.cap)
            a.nbr[size_t(listed) * a.n_dest + pos] = S.base + k;
          ++listed;
        }
        pair(walk::rec<T>(S.pos, k), walk::rec<T>(S.mass, k));
      };
      const walk::Rec<T> di{xi, yi, zi, hi};
      if (PERIODIC)
        walk::walk_rows_periodic(a, S.cell_start, S.cell_end, S.pos, l, di,
                                 rs, box, walker, body);
      else
        walk::walk_rows(a, S.cell_start, S.cell_end, S.pos, l, 1, di, rs,
                        walker, body);
      walker.finish(body);
    }
  }
  if (!active) return;
  if (MODE == kEmit) {
    a.count[pos] = listed;
    if (listed > a.cap) atomicAdd(a.overflow, 1);
  }
  const bool wm = a.wmask == nullptr || a.wmask[i] != 0;
  constexpr int width = MOMENT ? 9 : 3;
#pragma unroll
  for (int e = 0; e < width; ++e) {
    const size_t at = width * size_t(i) + e;
    const T pre = ld<T>(a.pre, at);
    static_cast<T*>(a.out)[at] = wm ? pre + acc[e] : pre;
  }
  if (a.accepted != nullptr) a.accepted[i] = kept;
}

template <typename T, int MODE, bool MOMENT>
cudaError_t launch(const DeltaArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.n_dest + threads - 1) / threads;
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    constexpr int K = decltype(kind)::value;
    if (a.periodic)
      delta_pair_kernel<T, K, MODE, MOMENT, true>
          <<<blocks, threads, 0, stream>>>(a);
    else
      delta_pair_kernel<T, K, MODE, MOMENT, false>
          <<<blocks, threads, 0, stream>>>(a);
    return cudaGetLastError();
  });
}

// the moment group walks or emits; the gradient groups walk or consume
template <typename T>
cudaError_t launch_mode(const DeltaArgs& a, cudaStream_t stream) {
  if (a.terms == kMmat)
    return a.mode == kEmit ? launch<T, kEmit, true>(a, stream)
                           : launch<T, kWalk, true>(a, stream);
  return a.mode == kConsume ? launch<T, kConsume, false>(a, stream)
                            : launch<T, kWalk, false>(a, stream);
}

bool args_ok(const DeltaArgs& a) {
  const bool terms_ok = a.terms == kMmat || a.terms == (kCorr | kGrad) ||
                        a.terms == kGrad;
  const bool dims_ok = (a.terms & (kMmat | kCorr))
                           ? a.mdim >= 1 && a.mdim <= 3
                           : a.mdim == 0;
  const bool mode_ok =
      a.mode == kWalk ||
      (a.mode == kEmit && a.terms == kMmat && a.overflow != nullptr) ||
      (a.mode == kConsume && a.terms != kMmat && a.pack.n_src == 0);
  const bool list_ok = a.mode == kWalk ||
                       (a.cap >= 1 && a.nbr != nullptr &&
                        a.count != nullptr);
  bool bases_ok = a.src[0].base == 0;
  for (int s = 1; s < a.n_src && s < kDeltaSources; ++s)
    bases_ok = bases_ok && a.src[s].base >= a.src[s - 1].base;
  return terms_ok && dims_ok && mode_ok && list_ok && bases_ok &&
         a.n_src >= 1 && a.n_src <= kDeltaSources && a.nx >= 1 &&
         a.ny >= 1 && a.nz >= 1 && a.dim >= 1 && a.dim <= 3 &&
         shapes::built_kind(a.kernel_kind) &&
         (a.dtype == 0 || a.dtype == 1) && pack::args_ok(a.pack) &&
         (a.pack.n_src == 0 || a.pack.dtype == a.dtype) &&
         a.dorder != nullptr && a.cell != nullptr && a.pre != nullptr &&
         a.out != nullptr &&
         ((a.terms & kCorr) == 0 || a.m_mat != nullptr) &&
         ((a.terms & kGrad) == 0 || a.rho != nullptr);
}

}  // namespace

extern "C" {

int delta_pair_args_size() { return static_cast<int>(sizeof(DeltaArgs)); }

int delta_pair_launch(const DeltaArgs* args, void* stream) {
  const DeltaArgs a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  const cudaError_t rc =
      a.dtype == 0 ? launch_mode<float>(a, st) : launch_mode<double>(a, st);
  return static_cast<int>(rc);
}

const char* delta_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
