// WCSPH pair kernel for Hopper (sm_90a): a warp-coherent walk over the
// cell-sorted packed sources.
//
// Replaces pysph_tpu/ops/resident.py::_pair_kernel_resident for the
// equations of WCSPHScheme: ContinuityEquation, MomentumEquation
// (artificial viscosity and the dt_cfl max, and with --tensile-correction
// Monaghan's tensile correction) and XSPHCorrection, the main group's
// delta-SPH terms (ContinuityEquationDeltaSPH, MomentumEquationDeltaSPH,
// LaminarViscosityDeltaSPH), LaminarViscosity, and the
// --summation-density group's SummationDensity (a launch of its own),
// with any shape of csrc/shapes.cuh, on an open grid or on the
// Taylor-Green vortex's box periodic in x and y (examples/taylor_green.py
// --scheme wcsph).  (The delta-SPH pre-phases are csrc/delta_pair.cu.)
// One launch computes every pair term of one dest array over all of its
// sources (at most 4), and writes each output once.
//
// What bounds it: the candidates of the 3^dim-cell stencil (~280 a dest
// on dam_break_3d, 17% of them in support) and the pair body of those in
// support.  Walking them one dest per thread, in unrelated cells, costs
// a chained index load and four scattered loads per candidate, and the
// pair body runs whenever any lane of the warp has a pair in support.
//
// Design (csrc/cell_walk.cuh): thread t takes the dest at position t of
// the dest's sorted order, so a warp holds dests of one or a few nearby
// cells.  Each lane walks its own cells cx - 1 .. cx + 1 as one span in
// each of the 3^(dim-1) stencil rows of the packed copy (csrc/
// cell_pack.cuh, launched by this file's launch function just before the
// walk): one 16-byte record load per candidate, no index, and the lanes
// of one cell load the same records at the same steps.  The candidates
// in support are kept as bits and handed to the pair body a round at a
// time, one per lane, so the body runs with most lanes busy.  On a
// periodic grid (the template flag PERIODIC) the rows wrap, a row that
// crosses the grid's end on x is two ranges (walk::walk_rows_periodic),
// and every displacement is the minimum image.
// No shared memory, no block barrier and no atomics: the result is the
// same on every run, and each lane sums its pairs in the order of the
// plain stencil walk.  The per-pair body, the shape functions and the
// argument struct are in wcsph_terms.cuh, shared with csrc/dense_pair.cu.
//
// Interface: plain C, called through ctypes (ops/wcsph_pair.py).  The
// launch function takes a host pointer to WcsphArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack and
// then the walk, and returns cudaGetLastError().

#include "wcsph_terms.cuh"

namespace {

using wcsph::Cand;
using wcsph::Dest;

// 8 blocks of 128 threads an SM in float (64 registers a thread): the
// walk waits on its loads, so more warps in flight hide more of it.
// DELTA: built with kDcont and kDmom (a call whose sources take one);
// EXTRA: with the kExtra terms (kLvisc, kTens, kSumRho, kLvd, runtime
// branches on the term mask); PERIODIC: the periodic walk and the minimum
// image.  Each flag is a template parameter, so that the kernels built
// without it are the code they were before it.
template <typename T, int KIND, bool DELTA, bool EXTRA, bool PERIODIC>
__global__ void __launch_bounds__(128, sizeof(T) == 4 ? 8 : 4)
    wcsph_pair_kernel(const WcsphArgs a) {
  // every lane stays to the end: the walk's votes take the whole warp
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pos < a.n_dest;
  const int i = active ? a.dorder[pos] : 0;
  const walk::Lane l = walk::lane_cell(a, active ? a.cell[i] : 0, active);

  Dest<T> d{};
  if (active) d.template load<DELTA, EXTRA>(a, i, wcsph::dest_terms(a));
  const T rs = T(a.radius_scale), kfac = T(a.kfac);
  const walk::Box<T> box = wcsph::box_of<T>(a);

  walk::Walker<T> walker;
  walker.begin();
  for (int s = 0; s < a.n_src; ++s) {
    const SrcArgs& S = a.src[s];
    const int terms = S.terms;
    const bool thermo =
        terms & (kMom | kXsph | (DELTA ? kDcont | kDmom : 0) |
                 (EXTRA ? kLvisc | kLvd : 0));
    const bool grad = DELTA && (terms & kDcont);
    const T c0 = T(S.c0), alpha = T(S.alpha), beta = T(S.beta);
    const T xeps = T(S.xsph_eps);
    const wcsph::DeltaConsts<T> dc = wcsph::delta_consts<T>(S);
    const wcsph::ExtraConsts<T> ec = wcsph::extra_consts<T>(a, S);
    auto body = [&](int k) {
      Cand<T> c;
      c.pos = wcsph::rec<T>(S.pos, k);
      c.vel = wcsph::rec<T>(S.vel, k);
      c.th = thermo ? wcsph::rec<T>(S.thermo, k) : wcsph::Rec<T>{};
      c.gr = grad ? wcsph::rec<T>(S.grad, k) : wcsph::Rec<T>{};
      d.template pair<KIND, DELTA, EXTRA, PERIODIC>(
          c, k, terms, c0, alpha, beta, xeps, rs, kfac, a.dim, dc, ec, box);
    };
    wcsph::walk_rows<PERIODIC>(a, S, l, 1, d, rs, walker, body);
    walker.finish(body);
  }
  if (active) d.template store<EXTRA>(a, i);
}

template <typename T, int KIND, bool DELTA, bool EXTRA>
cudaError_t launch_kind(const WcsphArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.n_dest + threads - 1) / threads;
  if (a.periodic)
    wcsph_pair_kernel<T, KIND, DELTA, EXTRA, true>
        <<<blocks, threads, 0, stream>>>(a);
  else
    wcsph_pair_kernel<T, KIND, DELTA, EXTRA, false>
        <<<blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool DELTA, bool EXTRA>
cudaError_t launch(const WcsphArgs& a, cudaStream_t stream) {
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    return launch_kind<T, decltype(kind)::value, DELTA, EXTRA>(a, stream);
  });
}

template <typename T>
cudaError_t launch(const WcsphArgs& a, cudaStream_t stream) {
  int terms = 0;
  for (int s = 0; s < a.n_src; ++s) terms |= a.src[s].terms;
  const bool delta = terms & (kDcont | kDmom), extra = terms & kExtra;
  if (delta)
    return extra ? launch<T, true, true>(a, stream)
                 : launch<T, true, false>(a, stream);
  return extra ? launch<T, false, true>(a, stream)
               : launch<T, false, false>(a, stream);
}

}  // namespace

extern "C" {

int wcsph_pair_args_size() { return static_cast<int>(sizeof(WcsphArgs)); }

int wcsph_pair_launch(const WcsphArgs* args, void* stream) {
  const WcsphArgs a = *args;
  if (!wcsph::args_ok(a) || !shapes::built_kind(a.kernel_kind) ||
      a.dorder == nullptr || a.cell == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* wcsph_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
