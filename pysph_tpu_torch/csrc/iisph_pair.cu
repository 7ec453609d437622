// IISPH pair kernel for Hopper (sm_90a): the warp-coherent walk of
// csrc/cell_walk.cuh over the cell-sorted packed sources, on an open or a
// periodic grid.
//
// Replaces pysph_tpu/ops/resident.py::_pair_kernel_resident on the paths
// of IISPHScheme (pysph_tpu_torch/sph/iisph.py): the 2D dam break, the
// elliptical drop and the Taylor-Green vortex with --scheme iisph, where
// the TPU runs the scheme's groups in resident mode and its iterated
// pressure group inside a lax.while_loop.  The scheme's groups give six
// phase sets, one device functor each:
//
//   Density     NumberDensity, SummationDensity,
//               SummationDensityBoundary                   -> V rho
//   Advection   ComputeDII, ComputeDIIBoundary             -> dii0-2
//               ViscosityAcceleration(+Boundary)           -> au av aw
//   RhoAdv      ComputeRhoAdvection, ComputeRhoBoundary    -> rho_adv
//               ComputeAII, ComputeAIIBoundary             -> aii
//   Dijpj       ComputeDIJPJ                               -> dijpj0-2
//   Solve       PressureSolve, PressureSolveBoundary       -> p
//   Force       PressureForce, PressureForceBoundary       -> au av aw
//
// A per-source term mask (ops/iisph_pair.py) says which equations a
// source takes.  The functors, pair_of and the pair loop of one dest
// (iisph::sum_pairs) are csrc/iisph_terms.cuh's, which csrc/iisph_solve.cu
// (the iterated pressure group in one launch) shares.  The advected
// density's dt is the args' dt or, in the solver's chunks, the device
// value dt_at points at.  Any shape of csrc/shapes.cuh (QuinticSpline and
// Gaussian on the paths).  One launch computes every pair term of one dest array
// over all of its sources (at most 4) and writes each output once.
//
// Design, as csrc/tvf_pair.cu: thread t takes the dest at position t of
// the dest's sorted order, so a warp holds dests of one or a few nearby
// cells.  Each source is read from its packed copy (csrc/cell_pack.cuh,
// launched by this file's launch function just before the kernel), whose
// record planes are, as ops/iisph_pair.py PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: m rho V p
//   plane 2: u v w 0
//   plane 3: uadv vadv wadv 0
//   plane 4: dii0 dii1 dii2 piter
//   plane 5: dijpj0 dijpj1 dijpj2 0
// of which a source packs plane 0 and those its terms read (the pressure
// sweep's fluid source planes 0, 1, 4 and 5).  Each lane walks its own
// cells cx - 1 .. cx + 1 in each stencil row; on a periodic grid (the
// template flag PERIODIC) the rows wrap and every displacement is the
// minimum image (walk::walk_rows_periodic).  The walker hands the
// candidates in support to the pair body in rounds, one per lane; pair_of
// computes WIJ and DWIJ with the guards of the torch pair engine and the
// phase set's functor reads the records of the planes it needs and
// accumulates in registers.  The epilogue writes pre + sum under the
// write mask (Group real=True) and pre elsewhere.  No shared memory and
// no atomics, so the result is the same on every run.  Every dest read
// sees the value from before the phase; the planner refuses a set in
// which one equation reads what another accumulates.  The dest's own
// factors of a set are loaded once (the pressure sweep's
// m_i piter_i / rho_i^2 and dijpj_i).
//
// The linked launches (mode).  No group of IISPHScheme moves x y z h and
// the binning runs once an eval, so every launch of a dest after the
// first one that sees all its later sources walks the same pairs in the
// same order: up to 4 + 2k of them a step, k the pressure sweeps (2 to
// 30).  kWalk walks.  A walk of the Density or the Advection set with
// a.mode == kEmit (the first such launch of the dest, a runtime branch of
// the walking instantiation) also writes each dest's in-support
// candidates, in the order the body takes them, into the neighbour list:
// entry c of the dest at sorted position p is nbr[c * n_dest + p], a
// position in the numbering of all sources' copies (source s's position
// k is base_s + k), for c < cap; count[p] is the dest's number of pairs,
// which may exceed cap, and each such dest adds one to *overflow.
// kConsume (every later launch) packs its planes 1-5 (m rho V p, the
// velocities, dii and piter, dijpj: fresh every sweep) and reads plane 0
// from the emitting launch's copy; its sources are the emitter's, those it
// lacks with the term mask 0 (the fluid's ComputeDIJPJ against the dam
// break's fluid and wall): a warp whose dests all fit reads its lanes'
// listed records in list order, kListBatch loads in flight a lane,
// skipping the entries of a source of mask 0, and hands each to the same
// pair_of and functor as the walk, so its sums are the walk's bit for bit
// (built with ptxas's FMA contraction off, ops/build.py EXTRA_FLAGS, as
// tvf_pair); a warp with a dest past cap walks as kWalk, its sources of
// mask 0 skipped.
//
// What bounds it: operations.  A walking launch tests the candidates of
// the 3x3-cell stencil (a 16-byte record load, a support test each, the
// warp voting in rounds) and, per pair in support, computes the shape
// function and 10 to 40 flops on up to 9 source values; a consuming
// launch tests no candidate: its time is its pairs' arithmetic and their
// record loads (plane 0 from the emitter's copy, up to three planes from
// its own), the pressure sweep's four 16-byte records a pair the most.
// The bytes are a few records a particle.
//
// Interface: plain C, called through ctypes (ops/iisph_pair.py).  The
// launch function takes a host pointer to IisphArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack and
// then the kernel, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "iisph_terms.cuh"
#include "shapes.cuh"

// The argument struct is at global scope: the exported C functions take
// it, and a type in an unnamed namespace would give those functions
// internal linkage.  The sources, term bits, phases, planes and modes are
// csrc/iisph_terms.cuh's.
struct IisphArgs {
  const void *x, *y, *z, *h, *m, *rho, *u, *v, *w, *uadv, *vadv, *wadv,
      *dii0, *dii1, *dii2, *piter, *dijpj0, *dijpj1, *dijpj2, *p;  // dest
  const int32_t* cell;         // dest cell id, ix + nx * (iy + ny * iz)
  const int32_t* dorder;       // the dest's cell order: threads follow it
  const uint8_t* wmask;        // write mask (bool); null: every row
  const void* pre[kIisphOut];  // values before the phase; null: unused
  void* out[kIisphOut];
  // kEmit writes, kConsume reads: (cap, n_dest) entries, (n_dest) counts
  int32_t* nbr;
  int32_t* count;
  int32_t* overflow;  // kEmit: one per dest with more than cap pairs
  IisphSrc src[kIisphSources];
  double radius_scale, kfac;  // kfac: the kernel's sigma
  double dt;                  // the step's (the advected density)
  const double* dt_at;        // non-null: the step's dt on the device
  double box[3];  // the length of each periodic axis, 0 on the others
  int32_t n_dest, n_src, nx, ny, nz, dim, phase, dtype, kernel_kind,
      periodic, mode, cap;
  // the pack that fills the sources' planes: the launch function launches
  // it just before the kernel (n_src 0: none)
  PackArgs pack;
};

namespace {

using iisph::Advection;
using iisph::Density;
using iisph::Dijpj;
using iisph::Force;
using iisph::RhoAdv;
using iisph::Solve;
using walk::Rec;

// The blocks of 128 threads an SM that a kernel's __launch_bounds__ asks
// for: double 4; float 8 for the density walk, 6 else.
template <typename T, class PhaseSet>
constexpr int blocks_for() {
  return sizeof(T) == 8 ? 4
         : std::is_same<PhaseSet, Density<T>>::value ? 8
                                                     : 6;
}

// One kernel for every phase set: MODE kWalk (with a.mode == kEmit, the
// walk of an emitting set also writes the list) or kConsume.
template <typename T, int KIND, bool PERIODIC, class PhaseSet, int MODE>
__global__ void __launch_bounds__(128, (blocks_for<T, PhaseSet>()))
    iisph_pair_kernel(const IisphArgs a) {
  // every lane stays to the end: the walk's votes take the whole warp
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pos < a.n_dest;
  const int i = active ? a.dorder[pos] : 0;

  Rec<T> di{};  // {xi, yi, zi, hi}
  PhaseSet ph;
  if (active) {
    di = {iisph::ld<T>(a.x, i), iisph::ld<T>(a.y, i), iisph::ld<T>(a.z, i),
          iisph::ld<T>(a.h, i)};
    ph.load(a, i);
  }
  const bool emit = MODE == kWalk && PhaseSet::kEmits && a.mode == kEmit;
  auto src = [&](int s) -> const IisphSrc& { return a.src[s]; };
  iisph::sum_pairs<T, KIND, PERIODIC, MODE>(a, src, a.n_src, pos, active, i,
                                            di, ph, emit);
  if (active) ph.store(a, i, a.wmask == nullptr || a.wmask[i] != 0);
}

constexpr int kThreads = 128;

template <typename T, int KIND, bool PERIODIC, class PhaseSet>
void launch_set(const IisphArgs& a, int blocks, cudaStream_t stream) {
  if (a.mode == kConsume)
    iisph_pair_kernel<T, KIND, PERIODIC, PhaseSet, kConsume>
        <<<blocks, kThreads, 0, stream>>>(a);
  else
    iisph_pair_kernel<T, KIND, PERIODIC, PhaseSet, kWalk>
        <<<blocks, kThreads, 0, stream>>>(a);
}

// the Density set walks (or emits) only: no launch reads a list into it
template <typename T, int KIND, bool PERIODIC>
void launch_density(const IisphArgs& a, int blocks, cudaStream_t stream) {
  iisph_pair_kernel<T, KIND, PERIODIC, Density<T>, kWalk>
      <<<blocks, kThreads, 0, stream>>>(a);
}

template <typename T, int KIND, bool PERIODIC>
cudaError_t launch_walk(const IisphArgs& a, cudaStream_t stream) {
  const int blocks = (a.n_dest + kThreads - 1) / kThreads;
  switch (a.phase) {
    case kDensity:
      launch_density<T, KIND, PERIODIC>(a, blocks, stream);
      break;
    case kAdvection:
      launch_set<T, KIND, PERIODIC, Advection<T>>(a, blocks, stream);
      break;
    case kRhoAdvection:
      launch_set<T, KIND, PERIODIC, RhoAdv<T>>(a, blocks, stream);
      break;
    case kDijpjSet:
      launch_set<T, KIND, PERIODIC, Dijpj<T>>(a, blocks, stream);
      break;
    case kSolveSet:
      launch_set<T, KIND, PERIODIC, Solve<T>>(a, blocks, stream);
      break;
    default:
      launch_set<T, KIND, PERIODIC, Force<T>>(a, blocks, stream);
  }
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_kind(const IisphArgs& a, cudaStream_t stream) {
  return a.periodic ? launch_walk<T, KIND, true>(a, stream)
                    : launch_walk<T, KIND, false>(a, stream);
}

template <typename T>
cudaError_t launch(const IisphArgs& a, cudaStream_t stream) {
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    return launch_kind<T, decltype(kind)::value>(a, stream);
  });
}

// the phase sets whose walk emits, and those that consume (ops/
// iisph_pair.py EMITTING, CONSUMING)
bool emits(int phase) { return phase == kDensity || phase == kAdvection; }
bool consumes(int phase) { return phase >= kAdvection && phase <= kForceSet; }

bool args_ok(const IisphArgs& a) {
  const bool mode_ok =
      a.mode == kWalk ||
      (a.mode == kEmit && emits(a.phase) && a.overflow != nullptr) ||
      (a.mode == kConsume && consumes(a.phase));
  const bool list_ok = a.mode == kWalk ||
                       (a.cap >= 1 && a.nbr != nullptr &&
                        a.count != nullptr);
  bool bases_ok = a.n_src == 0 || a.src[0].base == 0;
  for (int s = 1; s < a.n_src && s < kIisphSources; ++s)
    bases_ok = bases_ok && a.src[s].base >= a.src[s - 1].base;
  // only a consuming launch skips a source (the emitter's it lacks)
  bool terms_ok = true;
  for (int s = 0; s < a.n_src && s < kIisphSources; ++s)
    terms_ok = terms_ok && (a.src[s].terms != 0 || a.mode == kConsume);
  return mode_ok && list_ok && bases_ok && terms_ok && a.n_src >= 0 &&
         a.n_src <= kIisphSources && a.nx >= 1 && a.ny >= 1 && a.nz >= 1 &&
         a.dim >= 1 && a.dim <= 3 && (a.dtype == 0 || a.dtype == 1) &&
         shapes::built_kind(a.kernel_kind) && a.phase >= kDensity &&
         a.phase <= kForceSet && a.dorder != nullptr && a.cell != nullptr &&
         pack::args_ok(a.pack) &&
         (a.pack.n_src == 0 || a.pack.dtype == a.dtype);
}

}  // namespace

extern "C" {

int iisph_pair_args_size() { return static_cast<int>(sizeof(IisphArgs)); }

int iisph_pair_launch(const IisphArgs* args, void* stream) {
  const IisphArgs a = *args;
  if (!args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* iisph_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
