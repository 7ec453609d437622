// IISPH's iterated pressure group for Hopper (sm_90a): every sweep of
// the relaxed-Jacobi solve of one fluid dest in one persistent launch.
//
// Replaces, on the paths of IISPHScheme (pysph_tpu_torch/sph/iisph.py:
// the Taylor-Green vortex, the elliptical drop and the 2D dam break with
// --scheme iisph), the sweeps that pysph_tpu/ops/resident.py::
// _run_iterated runs inside a lax.while_loop around
// _pair_kernel_resident (pysph_tpu/ops/resident.py:645): the group
// Group([ComputeDIJPJ], [PressureSolve, PressureSolveBoundary],
// iterate=True, min_iterations, max_iterations) of one dest, with
// PressureSolve's initialize, post_loop, reduce and converged.  Its loop
// condition is the JAX one, (it < max_it) & ~(conv & (it >= min_it)),
// evaluated on the card, so no sweep waits for the host.
//
// What bounds it: operations and latency.  A sweep is two passes over the
// dest's neighbour list (ComputeDIJPJ, then PressureSolve), each pair the
// shape function, DWIJ and 10-30 flops on up to three 16-byte records,
// and the passes depend on each other across the whole array: a dest's
// PressureSolve reads its neighbours' dijpj, the next sweep's ComputeDIJPJ
// their new piter.  Per sweep the work is ~0.1 ms at full width, so the
// launches, packs and elementwise kernels around two iisph_pair launches
// a sweep, and the host's read of converged, cost as much as the sums.
//
// Design.  One cooperative launch (cudaLaunchKernelEx with the cooperative
// attribute) of at most as many blocks of 128 threads as the card holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SMs; a
// larger grid is refused).  Block b takes the contiguous span of `tiles`
// x 128 of the dest's sorted positions from b x tiles x 128; thread t of
// tile j the position (b tiles + j) 128 + t, so a warp holds 32
// consecutive sorted dests, as iisph_pair's.  A grid barrier (cooperative
// groups' grid.sync(), which orders the memory of the grid) separates the
// phases of a sweep:
//   1. ComputeDIJPJ: each dest's sum over the list -> D (under the write
//      mask, 0 + sum as the pair launch's pre + sum);
//   2. barrier;
//   3. PressureSolve's sum over the list, then post_loop (its torch
//      operations in their order, each rounded: no contraction), the new
//      piter into the other piter buffer P[1 - q] (q: the sweep's
//      parity, so that no dest writes what a neighbour still reads), p
//      and compression into O; each thread's count and sum of
//      compression for reduce, summed over the block in a fixed order
//      into its partial;
//   4. barrier;
//   5. every block sums the partials in a fixed order (no atomics: a run
//      repeats its bits; the order follows the grid, which the card's SMs
//      and the build's registers size) and evaluates converged with
//      PressureSolve.converged's arithmetic (the division by rho0 a
//      multiplication by its reciprocal, as torch's CUDA division by a
//      host scalar), then the loop condition.
// The sweep count goes to a device int (and, where a log is given and the
// step is active, to the log); the last sweep's count and sum to
// tmp_comp.  On a step that the solver's chunk masks (active false) no
// sweep runs.
//
// No repacking.  The launch function first launches the source pack
// (csrc/cell_pack.cuh) of what the solve reads, once: the dest's planes
// M {m rho 0 0} (the fluid source's plane kMass), P[0] {dii0 dii1 dii2
// piter}, D {dijpj0 dijpj1 dijpj2 0} and O {aii rho_adv p compression},
// and each wall's {0 0 V 0}, all in cell order; P[1] is scratch.  The
// dest is its own fluid source, in the same cell order, so a dest and its
// neighbours read the same scratch.  Positions {x y z h} are the emitting
// iisph_pair launch's plane-0 copies (its hand-off), as the consuming
// launches read them.  At the end one pass scatters p, piter, compression
// and dijpj into the dest's order.
//
// Same pairs, same order, same bits: the pairs come from the emitting
// launch's neighbour list through csrc/iisph_terms.cuh's sum_pairs (a
// warp with a dest past the list's capacity walks) with the Dijpj and
// Solve functors of iisph_pair, built with ptxas's FMA contraction off as
// iisph_pair (ops/build.py EXTRA_FLAGS).  So p, piter and dijpj are the
// per-launch chain's (iisph_pair's Dijpj and Solve launches and the torch
// post_loop) bit for bit whenever the sweep counts agree; only reduce's
// sum order differs from torch.sum's.  The planes a sweep writes are read
// through L2 (iisph_terms.cuh LIVE), never through the read-only cache
// (plain loads, through L1, were no faster).
//
// Kinds: QuinticSpline (3) and Gaussian (2), the three runs' kernels, on
// an open and a periodic grid; the wrapper refuses the others.
//
// Interface: plain C, called through ctypes (ops/iisph_solve.py).  The
// launch function takes a host pointer to IisphSolveArgs and the stream,
// launches the pack and then the solve, and returns the CUDA error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "iisph_terms.cuh"
#include "shapes.cuh"

constexpr int kSolveThreads = 128;

// At global scope: the exported C functions take it.
struct IisphSolveArgs {
  // the dest's cells and the emitting launch's list (iisph::sum_pairs)
  const int32_t* cell;    // dest cell id by particle
  const int32_t* dorder;  // the dest's cell order
  const uint8_t* wmask;   // the group's write mask (bool); null: every row
  const int32_t* nbr;     // (cap, n_dest) entries
  const int32_t* count;   // (n_dest) pairs
  // the emitter's copies as sources, by sweep parity q (the fluid's plane
  // kDiiP is P[q]); terms: the fluid kDijpj | kSolve, a wall kSolveB
  IisphSrc src[2][kIisphSources];
  const void* pos;  // the dest's {x y z h}: the fluid copy's plane 0
  // (n_dest, 4) records in cell order: M and P[0], D, O packed at entry
  const void* M;
  void* P[2];
  void* D;
  void* O;
  void* partial;  // 2 values a block
  // outputs, in the dest's order
  void *p, *piter, *compression, *dijpj0, *dijpj1, *dijpj2;
  void* tmp_comp;            // 2 values: the last sweep's count and sum
  const void* tmp_comp_pre;  // its value before: kept where no sweep runs
  int32_t* sweeps;           // one int
  int32_t* log;     // null, or a count then log_cap entries (a ring)
  const uint8_t* active;  // null: the step runs; else a device bool
  const double* dt_at;    // non-null: the step's dt on the device
  double dt, radius_scale, kfac, rho0, omega, tolerance;
  double box[3];  // the length of each periodic axis, 0 on the others
  int32_t n_dest, n_src, nx, ny, nz, dim, dtype, kernel_kind, periodic, cap,
      min_it, max_it, log_cap;
  int32_t blocks;  // 0: as many as fit, at most one a 128 dests
  int32_t tiles;   // set by the launch function
  PackArgs pack;   // M, P[0], D, O and the walls' plane
};

namespace {

namespace cg = cooperative_groups;
using iisph::Dijpj;
using iisph::Solve;
using walk::Rec;
using walk::rec;

// Each operation of PressureSolve.post_loop rounded on its own, as its
// torch kernels round it (no contraction into an FMA).
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }
__device__ __forceinline__ double rcp(double a) { return __drcp_rn(a); }

__device__ __forceinline__ void put(void* plane, int k, const Rec<float>& r) {
  __stcg(reinterpret_cast<float4*>(plane) + k,
         make_float4(r.a, r.b, r.c, r.d));
}
__device__ __forceinline__ void put(void* plane, int k,
                                    const Rec<double>& r) {
  double2* q = reinterpret_cast<double2*>(plane) + 2 * k;
  __stcg(q, make_double2(r.a, r.b));
  __stcg(q + 1, make_double2(r.c, r.d));
}

template <typename T>
__device__ __forceinline__ T at(const void* p, int i) {
  return __ldcg(static_cast<const T*>(p) + i);
}

// The blocks of 128 threads an SM that the kernel asks registers for
// (float: IISPH_SOLVE_BLOCKS, a build flag for variants).
#ifndef IISPH_SOLVE_BLOCKS
#define IISPH_SOLVE_BLOCKS 5
#endif
template <typename T>
constexpr int solve_blocks() {
  return sizeof(T) == 8 ? 4 : IISPH_SOLVE_BLOCKS;
}

template <typename T, int KIND, bool PERIODIC>
__global__ void __launch_bounds__(kSolveThreads, (solve_blocks<T>()))
    iisph_solve_kernel(const __grid_constant__ IisphSolveArgs a) {
  constexpr int kWarps = kSolveThreads / 32;
  __shared__ T s_cnt[kWarps], s_tot[kWarps];
  __shared__ T s_sum[2];
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const bool run = a.active == nullptr || *a.active != 0;
  const double dtd = a.dt_at != nullptr ? *a.dt_at : a.dt;
  const T dt2 = T(dtd * dtd);
  const T rho0 = T(a.rho0), keep = T(1.0 - a.omega), omega = T(a.omega);
  const T tol = T(a.tolerance), rho0_1 = T(1) / rho0;
  auto wm = [&](int i) { return a.wmask == nullptr || a.wmask[i] != 0; };

  int it = 0;
  bool conv = false;
  T count = 0, total = 0;
  while (run && it < a.max_it && !(conv && it >= a.min_it)) {
    const int q = it & 1;
    auto src = [&](int s) -> const IisphSrc& { return a.src[q][s]; };
    // 1. ComputeDIJPJ
    for (int t = 0; t < a.tiles; ++t) {
      const int pos = (blockIdx.x * a.tiles + t) * kSolveThreads +
                      threadIdx.x;
      const bool active = pos < a.n_dest;
      const int i = active ? a.dorder[pos] : 0;
      const Rec<T> di = active ? rec<T>(a.pos, pos) : Rec<T>{};
      Dijpj<T, true> ph;
      iisph::sum_pairs<T, KIND, PERIODIC, kConsume>(a, src, a.n_src, pos,
                                                    active, i, di, ph, false);
      if (active && wm(i))
        put(a.D, pos, Rec<T>{T(0) + ph.d0, T(0) + ph.d1, T(0) + ph.d2, T(0)});
    }
    grid.sync();
    // 3. PressureSolve, its post_loop and the partials of reduce
    T cnt = 0, tot = 0;
    for (int t = 0; t < a.tiles; ++t) {
      const int pos = (blockIdx.x * a.tiles + t) * kSolveThreads +
                      threadIdx.x;
      const bool active = pos < a.n_dest;
      const int i = active ? a.dorder[pos] : 0;
      const Rec<T> di = active ? rec<T>(a.pos, pos) : Rec<T>{};
      Solve<T, true> ph;
      Rec<T> own{}, d{};
      if (active) {
        const Rec<T> mass = rec<T>(a.M, pos);  // m rho
        own = iisph::rec_live(static_cast<const T*>(a.P[q]), pos);
        d = iisph::rec_live(static_cast<const T*>(a.D), pos);
        ph.own(mass.a, mass.b, own.d, d.a, d.b, d.c, true);
      }
      iisph::sum_pairs<T, KIND, PERIODIC, kConsume>(a, src, a.n_src, pos,
                                                    active, i, di, ph, false);
      if (!active) continue;
      Rec<T> piter = own;
      if (wm(i)) {
        const Rec<T> o = iisph::rec_live(static_cast<const T*>(a.O), pos);
        const T p = T(0) + ph.p;  // the pair launch's pre (0) + sum
        // PressureSolve.post_loop
        const T tmp = sub(sub(rho0, o.b), mul(p, dt2));
        const T dnr = mul(o.a, dt2);
        const bool ok = fabs(dnr) > T(1e-9);
        const T safe = ok ? dnr : T(1);
        T x = add(mul(keep, own.d), mul(mul(rcp(safe), omega), tmp));
        x = isnan(x) ? x : fmax(x, T(0));
        const T pn = ok ? x : T(0);
        const T comp = pn != T(0) ? add(fabs(sub(mul(pn, dnr), tmp)), rho0)
                                  : rho0;
        piter.d = pn;
        put(a.O, pos, Rec<T>{o.a, o.b, pn, comp});
        // reduce: the compressed particles' count and the sum
        cnt += comp > T(0) ? T(1) : T(0);
        tot += comp;
      }
      put(a.P[1 - q], pos, piter);
    }
    // the block's partial, summed in a fixed order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cnt += __shfl_down_sync(walk::kFull, cnt, off);
      tot += __shfl_down_sync(walk::kFull, tot, off);
    }
    if (lane == 0) {
      s_cnt[warp] = cnt;
      s_tot[warp] = tot;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      T c = s_cnt[0], s = s_tot[0];
      for (int w = 1; w < kWarps; ++w) {
        c += s_cnt[w];
        s += s_tot[w];
      }
      T* part = static_cast<T*>(a.partial) + 2 * blockIdx.x;
      __stcg(part, c);
      __stcg(part + 1, s);
    }
    grid.sync();
    // 5. every block: the partials in a fixed order, then converged
    if (warp == 0) {
      T c = 0, s = 0;
      for (int b = lane; b < static_cast<int>(gridDim.x); b += 32) {
        c += at<T>(a.partial, 2 * b);
        s += at<T>(a.partial, 2 * b + 1);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        c += __shfl_down_sync(walk::kFull, c, off);
        s += __shfl_down_sync(walk::kFull, s, off);
      }
      if (lane == 0) {
        s_sum[0] = c;
        s_sum[1] = s;
      }
    }
    __syncthreads();
    count = s_sum[0];
    total = s_sum[1];
    __syncthreads();  // s_sum is written again after the next sweep
    ++it;
    // PressureSolve.converged
    const T avg = count > T(0) ? total / (count < T(1) ? T(1) : count)
                               : rho0;
    conv = !(fabs(avg - rho0) * rho0_1 > tol);
  }
  // the outputs, in the dest's order
  const int q = it & 1;
  for (int t = 0; t < a.tiles; ++t) {
    const int pos = (blockIdx.x * a.tiles + t) * kSolveThreads + threadIdx.x;
    if (pos >= a.n_dest) continue;
    const int i = a.dorder[pos];
    const Rec<T> d = iisph::rec_live(static_cast<const T*>(a.D), pos);
    const Rec<T> o = iisph::rec_live(static_cast<const T*>(a.O), pos);
    static_cast<T*>(a.p)[i] = o.c;
    static_cast<T*>(a.compression)[i] = o.d;
    static_cast<T*>(a.piter)[i] =
        iisph::rec_live(static_cast<const T*>(a.P[q]), pos).d;
    static_cast<T*>(a.dijpj0)[i] = d.a;
    static_cast<T*>(a.dijpj1)[i] = d.b;
    static_cast<T*>(a.dijpj2)[i] = d.c;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    T* tc = static_cast<T*>(a.tmp_comp);
    tc[0] = it ? count : iisph::ld<T>(a.tmp_comp_pre, 0);
    tc[1] = it ? total : iisph::ld<T>(a.tmp_comp_pre, 1);
    *a.sweeps = it;
    if (run && a.log != nullptr) {
      const int c = a.log[0];
      a.log[1 + c % a.log_cap] = it;
      a.log[0] = c + 1;
    }
  }
}

template <typename T, int KIND, bool PERIODIC>
cudaError_t launch_solve(IisphSolveArgs a, cudaStream_t stream) {
  auto kernel = iisph_solve_kernel<T, KIND, PERIODIC>;
  // the blocks that fit on the card at once, per instantiation
  static int fit = -1;
  if (fit < 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess)
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kSolveThreads, 0);
    if (rc != cudaSuccess) return rc;
    fit = per_sm * sms;
  }
  const int need = (a.n_dest + kSolveThreads - 1) / kSolveThreads;
  int blocks = a.blocks > 0 ? a.blocks : (need < fit ? need : fit);
  if (blocks > fit || blocks < 1) return cudaErrorCooperativeLaunchTooLarge;
  a.tiles = (need + blocks - 1) / blocks;
  // no block without a dest where the launch chooses
  if (a.blocks == 0) blocks = (need + a.tiles - 1) / a.tiles;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kSolveThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <typename T>
cudaError_t launch(const IisphSolveArgs& a, cudaStream_t stream) {
  if (a.kernel_kind == 2)
    return a.periodic ? launch_solve<T, 2, true>(a, stream)
                      : launch_solve<T, 2, false>(a, stream);
  return a.periodic ? launch_solve<T, 3, true>(a, stream)
                    : launch_solve<T, 3, false>(a, stream);
}

bool args_ok(const IisphSolveArgs& a) {
  bool srcs_ok = a.n_src >= 1 && a.n_src <= kIisphSources &&
                 a.src[0][0].base == 0;
  for (int q = 0; q < 2; ++q)
    for (int s = 1; s < a.n_src && s < kIisphSources; ++s)
      srcs_ok = srcs_ok && a.src[q][s].base >= a.src[q][s - 1].base;
  return srcs_ok && a.nx >= 1 && a.ny >= 1 && a.nz >= 1 && a.dim >= 1 &&
         a.dim <= 3 && (a.dtype == 0 || a.dtype == 1) &&
         (a.kernel_kind == 2 || a.kernel_kind == 3) && a.cap >= 1 &&
         a.nbr != nullptr && a.count != nullptr && a.dorder != nullptr &&
         a.cell != nullptr && a.pos != nullptr && a.M != nullptr &&
         a.P[0] != nullptr && a.P[1] != nullptr && a.D != nullptr &&
         a.O != nullptr && a.partial != nullptr && a.sweeps != nullptr &&
         a.tmp_comp != nullptr && a.tmp_comp_pre != nullptr &&
         a.min_it >= 0 && a.max_it >= 0 &&
         (a.log == nullptr || a.log_cap >= 1) && a.blocks >= 0 &&
         pack::args_ok(a.pack) && a.pack.n_src >= 1 &&
         a.pack.dtype == a.dtype;
}

}  // namespace

extern "C" {

int iisph_solve_args_size() {
  return static_cast<int>(sizeof(IisphSolveArgs));
}

int iisph_solve_launch(const IisphSolveArgs* args, void* stream) {
  const IisphSolveArgs a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* iisph_solve_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
