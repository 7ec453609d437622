// What the gas-dynamics pair kernels of ops/gasd_pair.py share: the
// argument structs of one call (a single ctypes struct, ops/gasd_pair.py
// _Args, describes both), the term bits, outputs, phase ids, modes and
// record planes, and the kernel's shape at one smoothing length.
// csrc/gasd_pair.cu runs GasDScheme's MPM sets with them, csrc/adke_pair.cu
// ADKEScheme's two sets.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell_pack.cuh"
#include "shapes.cuh"

constexpr int kGasdSources = 4;
// term bits, as ops/gasd_pair.py SDEN, MPM, ADEN, ADKE
constexpr int kSden = 1, kMpm = 2, kAden = 4, kAdke = 8;
// outputs in the order of ops/gasd_pair.py OUTPUTS
enum GasdOut {
  oRho, oArho, oGrhox, oGrhoy, oGrhoz, oDwdh, oAu, oAv, oAw, oAe, oDel2e,
  oDtCfl, kGasdOut
};
// phase ids: the index of the phase set in ops/gasd_pair.py PHASE_SETS
enum GasdPhase { kDensity, kMomentum, kAdkeDensity, kAdkeAccel };
// modes, as ops/gasd_pair.py WALK, SWEEP, CONSUME
enum GasdMode { kWalk, kSweep, kConsume };
// kSweep's outputs, the order of ops/gasd_pair.py SWEEP_OUTPUTS: the
// density sums, then what initialize and post_loop write
enum GasdSweep {
  wRho, wArho, wGrhox, wGrhoy, wGrhoz, wDwdh, wDiv, wOmega, wH, wAh,
  wConverged, kSweepOut
};
// kConsume: listed entries whose loads a lane has in flight
constexpr int kListBatch = 4;
// the record planes of a packed copy
enum GasdPlane { kPos, kVelM, kThermo, kSwitch, kGasdPlanes };

// The argument structs are at global scope: the exported C functions take
// them, and a type in an unnamed namespace would give those functions
// internal linkage.
struct GasdSrc {
  // the packed copy's planes, in the source's cell order; null where the
  // set reads none of the plane's props
  const void* plane[kGasdPlanes];
  const int32_t* cell_start;  // per cell: first position in the copy
  const int32_t* cell_end;    // per cell: one past the last
  double beta;                // MPMAccelerations', ADKEAccelerations' beta
  double alpha, g1, g2;        // ADKEAccelerations' alpha, g1, g2
  int32_t terms;
  int32_t base;  // its position 0 in the neighbour list's numbering
};

struct GasdArgs {
  const void *x, *y, *z, *h, *u, *v, *w, *rho, *p, *cs, *e, *omega,
      *alpha1, *alpha2, *div;  // dest
  const int32_t* cell;         // dest cell id, ix + nx * (iy + ny * iz)
  const int32_t* dorder;       // the dest's cell order: threads follow it
  const uint8_t* wmask;        // write mask (bool); null: every row
  const void* pre[kGasdOut];   // values before the phase; null: unused
  void* out[kGasdOut];
  int32_t* count;              // non-null: each dest's pairs in support
  GasdSrc src[kGasdSources];
  double radius_scale, kfac;   // kfac: the kernel's sigma
  double box[3];  // the length of each periodic axis, 0 on the others
  int32_t n_dest, n_src, nx, ny, nz, dim, phase, dtype, kernel_kind,
      periodic;
  // the modes (see the top): kSweep's gate, its dest props and outputs,
  // the count of the particles not converged, and the list it emits,
  // which kConsume reads where *use is set, with the copies' plane 0
  int32_t mode, cap;
  const uint8_t* run;          // kSweep: null or the gate
  const uint8_t* use;          // kConsume: read the list where *use != 0
  const void *m, *h0;          // kSweep: dest
  const void* swpre[11];       // kSweep: the values before, GasdSweep
  void* sw[11];                // order, and the outputs (in place: the
                               // same pointers)
  int32_t* unconv;             // kSweep: += the particles not converged
  int32_t* nbr;                // (cap, n_dest)
  int32_t* lcount;             // (n_dest): pairs by sorted position
  int32_t* overflow;           // kSweep: += dests with more than cap
  const void* hplane[kGasdSources];  // kConsume: the last sweep's plane 0
  double k, htol;              // SummationDensity's k and htol
  int32_t iterate_once, density_iterations;
  // the pack that fills the sources' planes: the launch function launches
  // it just before the kernel
  PackArgs pack;
};

namespace gasd {

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

template <typename T>
__device__ __forceinline__ T hpow(T h1, int dim) {
  return dim == 1 ? h1 : dim == 2 ? h1 * h1 : h1 * h1 * h1;
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

}  // namespace gasd
