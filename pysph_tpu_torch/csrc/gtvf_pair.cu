// GTVF pair kernel for Hopper (sm_90a): the warp-coherent walk of
// csrc/cell_walk.cuh over the cell-sorted packed sources.
//
// Replaces pysph_tpu/ops/pallas_engine.py::_pair_kernel_compact for the
// pair phases of GTVFScheme: the GTVF dam break (examples/dam_break_2d.py
// --scheme gtvf) and the Taylor-Green vortex on its box periodic in x
// and y (examples/taylor_green.py --scheme gtvf), and of the walls of
// TVFScheme (the last two sets' wall terms) and EDACScheme (the sixth).
// The two acceleration evaluators of GTVFIntegrator give five phase sets,
// EDACScheme's wall group a sixth, one device functor each:
//
//   WallVelocity   SetWallVelocity                       -> uf vf wf wij
//   Continuity     ContinuityEquationGTVF, ContinuitySolid -> arho
//   Density        CorrectDensity                        -> rho rhodiv
//   WallPressure   VolumeSummation, SolidWallPressureBC  -> V p wij
//   Momentum       MomentumEquationPressureGradient (with the kernel
//                  gradient at h/2), MomentumEquationViscosity,
//                  MomentumEquationArtificialStress
//                                          -> au av aw auhat avhat awhat
//   EdacWall       SourceNumberDensity, VolumeSummation, EDAC's
//                  SolidWallPressureBC and SetWallVelocity
//                                          -> wij V p uf vf wf
//
// (EDAC's wall pressure and velocity sum no wij, as TVF's do: their terms
// are their own, so that SourceNumberDensity's wij is summed once.)
//
// A per-source term mask (ops/gtvf_pair.py) says which equations a
// source takes.  Any smoothing kernel with a kernel_kind (csrc/shapes.cuh:
// WendlandQuintic on the dam break, QuinticSpline on the Taylor-Green
// vortex).  One launch computes every pair term of one dest array over
// all of its sources (at most 4) and writes each output once.
//
// What bounds it: the candidates of the 3x3-cell stencil and, per pair
// in support, 30 to 120 flops on 4 to 12 source values.  Walked one dest
// per thread in unrelated cells, each candidate cost a chained index load
// and four scattered loads, and the functor ran whenever any lane of the
// warp had a pair in support.
//
// Design, as csrc/wcsph_pair.cu: thread t takes the dest at position t
// of the dest's sorted order, so a warp holds dests of one or a few
// nearby cells.  Each source is read from its packed copy (csrc/
// cell_pack.cuh, launched by this file's launch function just before the
// walk), whose record planes are, as ops/gtvf_pair.py PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: m rho p rho0
//   plane 2: u v w 0
//   plane 3: uhat vhat what 0
//   plane 4: ug vg wg 0
// of which a source packs plane 0 and those its terms read (so one or two
// record loads a pair in support: WallPressure packs planes 0 and 1,
// Momentum 0 to 3).  Each lane walks its own cells cx - 1 .. cx + 1 as
// one span in each stencil row, tests the support r2 < (rs max(hi,
// hj))^2 on the {x y z h} records, and the walker hands the candidates in
// support to the pair body in rounds, one per lane; the body computes
// WIJ and DWIJ with the guards of the torch pair engine and hands the
// pair to the phase set's functor, which reads the records of the planes
// it needs and accumulates in registers.  The epilogue writes pre + sum
// under the write mask (Group real=True) and pre elsewhere.  No shared
// memory and no atomics, so the result is the same on every run, and
// each lane sums its pairs in the order of the plain stencil walk.  On a
// periodic grid (the template flag PERIODIC) the rows wrap, a row that
// crosses the grid's end on x is two ranges (walk::walk_rows_periodic),
// and every displacement, in the support test and in the pair, is the
// minimum image d - L rint(d / L) with the box lengths of the arguments.
// Every
// dest read sees the value from before the phase, as in the Pallas
// kernel; the planner refuses a phase set in which one equation reads
// what another accumulates.  No fast-math: CorrectDensity divides by the
// source's rho0, which is 0 on the walls, and the reference gives IEEE
// inf there; the pack copies the 0 as it is.
//
// Interface: plain C, called through ctypes (ops/gtvf_pair.py).  The
// launch function takes a host pointer to GtvfArgs (copied into the
// kernel's parameters) and the stream, launches the pack of a.pack and
// then the walk, and returns cudaGetLastError().

#include "cell_pack.cuh"
#include "cell_walk.cuh"
#include "shapes.cuh"

// The argument structs are at global scope: the exported C functions
// take them, and a type in an unnamed namespace would give those
// functions internal linkage.
constexpr int kMaxSources = 4;
// term bits, as ops/gtvf_pair.py
constexpr int kSwv = 1, kCgtvf = 2, kCsolid = 4, kCdens = 8, kVsum = 16,
              kWallp = 32, kMpg = 64, kMas = 128, kMvisc = 256, kSnd = 512,
              kEwallp = 1024, kEswv = 2048;
// outputs in the order of ops/gtvf_pair.py OUTPUTS
enum Out {
  oUf, oVf, oWf, oWij, oArho, oRho, oRhodiv, oV, oP,
  oAu, oAv, oAw, oAuhat, oAvhat, oAwhat, kNumOut
};
// phase ids: the index of the phase set in ops/gtvf_pair.py PHASE_SETS
enum Phase {
  kWallVelocity, kContinuity, kDensity, kWallPressure, kMomentum, kEdacWall
};
// the record planes of the packed copy (above)
enum Plane { kPos, kMass, kVel, kHat, kGhost, kPlanes };

struct SrcArgs {
  // the packed copy's planes, in the source's cell order; null where the
  // source's terms read none of the plane's props
  const void* plane[kPlanes];
  const int32_t* cell_start;  // per cell: first position in the copy
  const int32_t* cell_end;    // per cell: one past the last
  double gx, gy, gz;          // SolidWallPressureBC's gravity
  double nu;                  // MomentumEquationViscosity's
  int32_t terms, pad;
};

struct GtvfArgs {
  const void *x, *y, *z, *h, *rho, *p, *p0, *u, *v, *w, *uhat, *vhat,
      *what, *au, *av, *aw;  // dest
  const int32_t* cell;       // dest cell id, ix + nx * (iy + ny * iz)
  const int32_t* dorder;     // the dest's cell order: threads follow it
  const uint8_t* wmask;      // write mask (bool); null: every row
  const void* pre[kNumOut];  // values before the phase; null: unused
  void* out[kNumOut];
  SrcArgs src[kMaxSources];
  double radius_scale, kfac;  // kfac: the kernel's sigma
  double box[3];  // the length of each periodic axis, 0 on the others
  int32_t n_dest, n_src, nx, ny, nz, dim, phase, dtype, kernel_kind,
      periodic;
  // the pack that fills the sources' planes: the launch function launches
  // it just before the walk (n_src 0: none)
  PackArgs pack;
};

namespace {

using walk::Rec;
using walk::rec;

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

template <typename T>
__device__ __forceinline__ T hpow(T h1, int dim) {
  return dim == 1 ? h1 : dim == 2 ? h1 * h1 : h1 * h1 * h1;
}

// One pair in support, with the symbols the equations read: k is the
// source particle's position in its packed copy.
template <typename T>
struct Pair {
  int k;
  T xij, yij, zij, r2, rij, hij;
  T w;              // WIJ
  T dwx, dwy, dwz;  // DWIJ
};

// The output epilogue: pre + acc under the write mask, pre elsewhere.
template <typename T>
__device__ __forceinline__ void put(const GtvfArgs& a, int k, int i, T acc,
                                    bool wm) {
  if (a.out[k] == nullptr) return;
  const T pre = ld<T>(a.pre[k], i);
  static_cast<T*>(a.out[k])[i] = wm ? pre + acc : pre;
}

__host__ __device__ __forceinline__ int all_terms(const GtvfArgs& a) {
  int t = 0;
  for (int s = 0; s < a.n_src; ++s) t |= a.src[s].terms;
  return t;
}

// Each functor: kBlocks, the blocks of 128 threads an SM that its
// kernel's __launch_bounds__ asks for; load(a, i), the dest's values;
// pair(a, S, q), one pair in support; store(a, i, wm), the epilogue.
template <typename T>
struct WallVelocity {
  static constexpr int kBlocks = sizeof(T) == 4 ? 8 : 4;
  T uf = 0, vf = 0, wf = 0, wij = 0;
  __device__ void load(const GtvfArgs&, int) {}
  __device__ void pair(const GtvfArgs&, const SrcArgs& S,
                       const Pair<T>& q) {
    if (!(S.terms & kSwv)) return;
    const Rec<T> vj = rec<T>(S.plane[kVel], q.k);
    wij += q.w;
    uf += vj.a * q.w;
    vf += vj.b * q.w;
    wf += vj.c * q.w;
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oUf, i, uf, wm);
    put(a, oVf, i, vf, wm);
    put(a, oWf, i, wf, wm);
    put(a, oWij, i, wij, wm);
  }
};

template <typename T>
struct Continuity {
  static constexpr int kBlocks = sizeof(T) == 4 ? 8 : 4;
  T rhoi = 0, ui = 0, vi = 0, wi = 0, uhi = 0, vhi = 0, whi = 0;
  T arho = 0;
  __device__ void load(const GtvfArgs& a, int i) {
    const int t = all_terms(a);
    rhoi = ld<T>(a.rho, i);
    if (t & kCgtvf) {
      uhi = ld<T>(a.uhat, i);
      vhi = ld<T>(a.vhat, i);
      whi = ld<T>(a.what, i);
    }
    if (t & kCsolid) {
      ui = ld<T>(a.u, i);
      vi = ld<T>(a.v, i);
      wi = ld<T>(a.w, i);
    }
  }
  __device__ void pair(const GtvfArgs&, const SrcArgs& S,
                       const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);
    const T mj = mass.a, rhoj = mass.b;
    if (S.terms & kCgtvf) {  // ContinuityEquationGTVF
      const Rec<T> hat = rec<T>(S.plane[kHat], q.k);
      const T udotdij = q.dwx * (uhi - hat.a) + q.dwy * (vhi - hat.b) +
                        q.dwz * (whi - hat.c);
      arho += rhoi * mj / rhoj * udotdij;
    }
    if (S.terms & kCsolid) {  // ContinuitySolid
      const Rec<T> g = rec<T>(S.plane[kGhost], q.k);
      const T Vj = mj / rhoj;
      const T vdotdw =
          (ui - g.a) * q.dwx + (vi - g.b) * q.dwy + (wi - g.c) * q.dwz;
      arho += rhoi * Vj * vdotdw;
    }
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oArho, i, arho, wm);
  }
};

template <typename T>
struct Density {
  static constexpr int kBlocks = sizeof(T) == 4 ? 8 : 4;
  T rho = 0, rhodiv = 0;
  __device__ void load(const GtvfArgs&, int) {}
  __device__ void pair(const GtvfArgs&, const SrcArgs& S,
                       const Pair<T>& q) {
    if (!(S.terms & kCdens)) return;  // CorrectDensity
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);
    const T mw = mass.a * q.w;
    rho += mw;
    rhodiv += mw / mass.d;  // inf where rho0 is 0
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oRho, i, rho, wm);
    put(a, oRhodiv, i, rhodiv, wm);
  }
};

template <typename T>
struct WallPressure {
  static constexpr int kBlocks = sizeof(T) == 4 ? 8 : 4;
  T aui = 0, avi = 0, awi = 0;
  T V = 0, p = 0, wij = 0;
  __device__ void load(const GtvfArgs& a, int i) {
    if (all_terms(a) & kWallp) {
      aui = ld<T>(a.au, i);
      avi = ld<T>(a.av, i);
      awi = ld<T>(a.aw, i);
    }
  }
  __device__ void pair(const GtvfArgs&, const SrcArgs& S,
                       const Pair<T>& q) {
    if (S.terms & kVsum) V += q.w;  // VolumeSummation
    if (S.terms & kWallp) {         // SolidWallPressureBC
      const T gdotxij = (T(S.gx) - aui) * q.xij + (T(S.gy) - avi) * q.yij +
                        (T(S.gz) - awi) * q.zij;
      const Rec<T> mass = rec<T>(S.plane[kMass], q.k);
      p += mass.c * q.w + mass.b * gdotxij * q.w;
      wij += q.w;
    }
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oV, i, V, wm);
    put(a, oP, i, p, wm);
    put(a, oWij, i, wij, wm);
  }
};

// The dest's parts of both equations are computed once in load():
// pi / rhoi^2, -p0i / rhoi^2 and the nine ui[c] uidif[d] / rhoi, so that
// a pair in support divides twice where it divided 21 times.  KIND: the
// shape of the h/2 gradient; VISC: built with kMvisc (a template flag, so
// that the dam break's Momentum is the code it was before it).
template <typename T, int KIND, bool VISC>
struct Momentum {
  static constexpr int kBlocks = sizeof(T) == 4 ? 7 : 4;
  T pirho2 = 0, p0rho2 = 0;
  T si[3][3] = {};  // ui[c] uidif[d] / rhoi
  T rhoi = 0, ui[3] = {};  // kMvisc
  T au = 0, av = 0, aw = 0, auhat = 0, avhat = 0, awhat = 0;
  __device__ void load(const GtvfArgs& a, int i) {
    const int t = all_terms(a);
    const T rhoi = ld<T>(a.rho, i);
    const T rhoi2 = rhoi * rhoi;
    if (VISC && (t & kMvisc)) {
      this->rhoi = rhoi;
      ui[0] = ld<T>(a.u, i);
      ui[1] = ld<T>(a.v, i);
      ui[2] = ld<T>(a.w, i);
    }
    if (t & kMpg) {
      pirho2 = ld<T>(a.p, i) / rhoi2;
      p0rho2 = -ld<T>(a.p0, i) / rhoi2;
    }
    if (t & kMas) {
      const T ui[3] = {ld<T>(a.u, i), ld<T>(a.v, i), ld<T>(a.w, i)};
      const T uidif[3] = {ld<T>(a.uhat, i) - ui[0], ld<T>(a.vhat, i) - ui[1],
                          ld<T>(a.what, i) - ui[2]};
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int d = 0; d < 3; ++d) si[c][d] = ui[c] * uidif[d] / rhoi;
    }
  }
  __device__ void pair(const GtvfArgs& a, const SrcArgs& S,
                       const Pair<T>& q) {
    const Rec<T> mass = rec<T>(S.plane[kMass], q.k);
    const T mj = mass.a, rhoj = mass.b;
    if (S.terms & kMpg) {  // MomentumEquationPressureGradient
      const T pij = pirho2 + mass.c / (rhoj * rhoj);
      const T tmp = -mj * pij;
      au += tmp * q.dwx;
      av += tmp * q.dwy;
      aw += tmp * q.dwz;
      // SPH_KERNEL.gradient(XIJ, RIJ, 0.5 * HIJ)
      const T h = T(0.5) * q.hij;
      const T h1 = T(1) / h;
      T wq, dwq;
      shapes::shape<T, KIND>(q.rij * h1, wq, dwq);
      const T wdash = dwq * (T(a.kfac) * hpow(h1, a.dim));
      const T g = q.rij > T(1e-12) ? wdash / (h * q.rij) : T(0);
      const T tmph = p0rho2 * mj;
      auhat += tmph * (g * q.xij);
      avhat += tmph * (g * q.yij);
      awhat += tmph * (g * q.zij);
    }
    if (VISC && (S.terms & kMvisc)) {  // MomentumEquationViscosity
      const Rec<T> vel = rec<T>(S.plane[kVel], q.k);
      const T etai = T(S.nu) * rhoi, etaj = T(S.nu) * rhoj;
      const T etaij = T(4) * (etai * etaj) / (etai + etaj);
      const T xdotdij = q.dwx * q.xij + q.dwy * q.yij + q.dwz * q.zij;
      const T tmp = mj / (rhoi * rhoj);
      const T fac =
          tmp * etaij * xdotdij / (q.r2 + T(0.01) * q.hij * q.hij);
      au += fac * (ui[0] - vel.a);
      av += fac * (ui[1] - vel.b);
      aw += fac * (ui[2] - vel.c);
    }
    if (S.terms & kMas) {  // MomentumEquationArtificialStress
      const Rec<T> vel = rec<T>(S.plane[kVel], q.k);
      const Rec<T> hat = rec<T>(S.plane[kHat], q.k);
      const T rhoj1 = T(1) / rhoj;
      const T uj[3] = {vel.a, vel.b, vel.c};
      const T ujdif[3] = {hat.a - uj[0], hat.b - uj[1], hat.c - uj[2]};
      const T dw[3] = {q.dwx, q.dwy, q.dwz};
      T res[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        T acc = T(0);
#pragma unroll
        for (int d = 0; d < 3; ++d)
          acc += (si[c][d] + uj[c] * ujdif[d] * rhoj1) * dw[d];
        res[c] = acc;
      }
      au += mj * res[0];
      av += mj * res[1];
      aw += mj * res[2];
    }
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oAu, i, au, wm);
    put(a, oAv, i, av, wm);
    put(a, oAw, i, aw, wm);
    put(a, oAuhat, i, auhat, wm);
    put(a, oAvhat, i, avhat, wm);
    put(a, oAwhat, i, awhat, wm);
  }
};

// EDACScheme's wall group: the number density of the fluid, the volume,
// the pressure and the velocity sums (their post_loops divide by wij).
template <typename T>
struct EdacWall {
  static constexpr int kBlocks = sizeof(T) == 4 ? 8 : 4;
  T aui = 0, avi = 0, awi = 0;
  T wij = 0, V = 0, p = 0, uf = 0, vf = 0, wf = 0;
  __device__ void load(const GtvfArgs& a, int i) {
    if (all_terms(a) & kEwallp) {
      aui = ld<T>(a.au, i);
      avi = ld<T>(a.av, i);
      awi = ld<T>(a.aw, i);
    }
  }
  __device__ void pair(const GtvfArgs&, const SrcArgs& S,
                       const Pair<T>& q) {
    if (S.terms & kSnd) wij += q.w;  // SourceNumberDensity
    if (S.terms & kVsum) V += q.w;   // VolumeSummation
    if (S.terms & kEwallp) {         // SolidWallPressureBC (EDAC)
      const T gdotxij = (T(S.gx) - aui) * q.xij + (T(S.gy) - avi) * q.yij +
                        (T(S.gz) - awi) * q.zij;
      const Rec<T> mass = rec<T>(S.plane[kMass], q.k);
      p += mass.c * q.w + mass.b * gdotxij * q.w;
    }
    if (S.terms & kEswv) {  // SetWallVelocity (EDAC)
      const Rec<T> vj = rec<T>(S.plane[kVel], q.k);
      uf += vj.a * q.w;
      vf += vj.b * q.w;
      wf += vj.c * q.w;
    }
  }
  __device__ void store(const GtvfArgs& a, int i, bool wm) {
    put(a, oWij, i, wij, wm);
    put(a, oV, i, V, wm);
    put(a, oP, i, p, wm);
    put(a, oUf, i, uf, wm);
    put(a, oVf, i, vf, wm);
    put(a, oWf, i, wf, wm);
  }
};

// The walk shared by every phase set; KIND: the shape function;
// PERIODIC: the periodic walk and the minimum image.
template <typename T, int KIND, bool PERIODIC, class PhaseSet>
__global__ void __launch_bounds__(128, PhaseSet::kBlocks)
    gtvf_pair_kernel(const GtvfArgs a) {
  // every lane stays to the end: the walk's votes take the whole warp
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = pos < a.n_dest;
  const int i = active ? a.dorder[pos] : 0;
  const walk::Lane l = walk::lane_cell(a, active ? a.cell[i] : 0, active);

  Rec<T> di{};  // {xi, yi, zi, hi}
  PhaseSet ph;
  if (active) {
    di = {ld<T>(a.x, i), ld<T>(a.y, i), ld<T>(a.z, i), ld<T>(a.h, i)};
    ph.load(a, i);
  }
  const T rs = T(a.radius_scale), kfac = T(a.kfac);
  const walk::Box<T> box{{T(a.box[0]), T(a.box[1]), T(a.box[2])}};

  walk::Walker<T> walker;
  walker.begin();
  for (int s = 0; s < a.n_src; ++s) {
    const SrcArgs& S = a.src[s];
    auto body = [&](int k) {
      const Rec<T> pj = rec<T>(S.plane[kPos], k);
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
      q.r2 = r2;
      q.hij = T(0.5) * (di.d + pj.d);
      const T rinv = r2 > T(1e-24) ? T(1) / sqrt(r2) : T(0);
      q.rij = r2 * rinv;
      const T h1 = T(1) / (q.hij > T(0) ? q.hij : T(1));
      T wq, dwq;
      shapes::shape<T, KIND>(q.rij * h1, wq, dwq);
      const T fac = kfac * hpow(h1, a.dim);
      q.w = wq * fac;
      const T gr = q.rij > T(1e-12) ? dwq * fac * h1 * rinv : T(0);
      q.dwx = gr * q.xij;
      q.dwy = gr * q.yij;
      q.dwz = gr * q.zij;
      ph.pair(a, S, q);
    };
    if (PERIODIC)
      walk::walk_rows_periodic(a, S.cell_start, S.cell_end, S.plane[kPos],
                               l, di, rs, box, walker, body);
    else
      walk::walk_rows(a, S.cell_start, S.cell_end, S.plane[kPos], l, 1, di,
                      rs, walker, body);
    walker.finish(body);
  }
  if (active) ph.store(a, i, a.wmask == nullptr || a.wmask[i] != 0);
}

template <typename T, int KIND, bool PERIODIC>
cudaError_t launch_walk(const GtvfArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.n_dest + threads - 1) / threads;
  switch (a.phase) {
    case kWallVelocity:
      gtvf_pair_kernel<T, KIND, PERIODIC, WallVelocity<T>>
          <<<blocks, threads, 0, stream>>>(a);
      break;
    case kContinuity:
      gtvf_pair_kernel<T, KIND, PERIODIC, Continuity<T>>
          <<<blocks, threads, 0, stream>>>(a);
      break;
    case kDensity:
      gtvf_pair_kernel<T, KIND, PERIODIC, Density<T>>
          <<<blocks, threads, 0, stream>>>(a);
      break;
    case kWallPressure:
      gtvf_pair_kernel<T, KIND, PERIODIC, WallPressure<T>>
          <<<blocks, threads, 0, stream>>>(a);
      break;
    case kMomentum:
      if (all_terms(a) & kMvisc)
        gtvf_pair_kernel<T, KIND, PERIODIC, Momentum<T, KIND, true>>
            <<<blocks, threads, 0, stream>>>(a);
      else
        gtvf_pair_kernel<T, KIND, PERIODIC, Momentum<T, KIND, false>>
            <<<blocks, threads, 0, stream>>>(a);
      break;
    case kEdacWall:
      gtvf_pair_kernel<T, KIND, PERIODIC, EdacWall<T>>
          <<<blocks, threads, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, int KIND>
cudaError_t launch_kind(const GtvfArgs& a, cudaStream_t stream) {
  return a.periodic ? launch_walk<T, KIND, true>(a, stream)
                    : launch_walk<T, KIND, false>(a, stream);
}

template <typename T>
cudaError_t launch(const GtvfArgs& a, cudaStream_t stream) {
  return shapes::with_kind(a.kernel_kind, [&](auto kind) {
    return launch_kind<T, decltype(kind)::value>(a, stream);
  });
}

}  // namespace

extern "C" {

int gtvf_pair_args_size() { return static_cast<int>(sizeof(GtvfArgs)); }

int gtvf_pair_launch(const GtvfArgs* args, void* stream) {
  const GtvfArgs a = *args;
  if (a.n_src < 0 || a.n_src > kMaxSources || a.nx < 1 || a.ny < 1 ||
      a.nz < 1 || a.dim < 1 || a.dim > 3 || (a.dtype != 0 && a.dtype != 1) ||
      !shapes::built_kind(a.kernel_kind) ||
      a.dorder == nullptr || a.cell == nullptr || !pack::args_ok(a.pack) ||
      (a.pack.n_src != 0 && a.pack.dtype != a.dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_dest <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* gtvf_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
