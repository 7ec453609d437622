// Fused continuity + momentum pair kernel for Hopper (sm_90a).
//
// Replaces pysph_tpu/ops/pallas_pair.py::_row_kernel (reached through
// fused_continuity_momentum): ContinuityEquation and the Monaghan
// MomentumEquation with artificial viscosity, hand-fused, for one array
// against itself, with the CubicSpline kernel and unit mass.  It computes
// exactly pallas_pair.py:102-147:
//
// - the pair is kept when r2 < (2 max(hi, hj))^2 and both h are > 0 (a
//   dest with h <= 0 gives 0, as an empty slot does there);
// - CubicSpline at hij = (hi + hj) / 2, dW/dr = fac(hij) dw/dq / hij;
// - rinv = 0 for r <= 1e-12, so the self pair adds 0;
// - piij = (-alpha c0 muij + beta muij^2) / rhoij where vij.xij < 0 (a
//   fixed c0, no per-particle sound speed), muij = hij vij.xij /
//   (r2 + eps_fac hij^2);
// - rho^2 clamped at 1e-30 in the pressure term;
// - fresh sums (no pre values, no write mask): arho += vij.dwij,
//   a -= (pi/rhoi^2 + pj/rhoj^2 + piij) dwij.
//
// What bounds it: like csrc/gtvf_pair.cu, the candidates of the
// 3^dim-cell stencil (a chained index load and four scattered loads each
// when walked one dest per thread in unrelated cells) and ~65 flops per
// pair in support.
//
// Design (csrc/cell_walk.cuh, as csrc/wcsph_pair.cu): this file's launch
// function first packs the array (csrc/cell_pack.cuh) in its cell order
// into record planes, as ops/fused_pair.py PACK_RECORDS:
//   plane 0: x y z h
//   plane 1: u v w 0
//   plane 2: rho p 0 0
// Thread t takes the particle at position t of the cell order and reads
// its own values from records t, so the dest loads are coalesced too.
// Each lane walks its own cells cx - 1 .. cx + 1 as one span in each
// stencil row, tests r2 < (2 max(hi, hj))^2 on the {x y z h} records (the
// support radius is 2 whatever the grid's radius_scale, which may be
// larger), and the walker hands the candidates in support to the pair
// body in rounds, one per lane.  A dest with h <= 0 walks nothing but
// stays in the warp's votes and writes zeros; the body rejects a
// candidate with !(hj > 0), which the support test alone would keep.  No
// shared memory and no atomics, so runs repeat exactly, and each lane
// sums its pairs in the order of the plain stencil walk.
//
// Interface: plain C through ctypes (ops/fused_pair.py):
// fused_pair_launch(const FusedArgs*, stream) launches the pack of
// a.pack, then the walk, and returns cudaGetLastError().

#include "cell_pack.cuh"
#include "cell_walk.cuh"

enum Plane { kPos, kVel, kThermo, kPlanes };

struct FusedArgs {
  const void* plane[kPlanes];  // the packed copy (above), in cell order
  const int32_t* cell;         // cell id, ix + nx * (iy + ny * iz)
  const int32_t* order;        // particle indices sorted by cell
  const int32_t* cell_start;   // per cell: first position in order
  const int32_t* cell_end;     // per cell: one past the last
  void* out[4];                // arho, au, av, aw
  double c0, alpha, beta, eps_fac;
  int32_t n, nx, ny, nz, dim, dtype;
  // the pack that fills the planes, launched just before the walk
  PackArgs pack;
};

namespace {

using walk::Rec;
using walk::rec;

constexpr double kPi = 3.14159265358979323846;

// 8 blocks of 128 threads an SM in float, as csrc/wcsph_pair.cu
template <typename T>
__global__ void __launch_bounds__(128, sizeof(T) == 4 ? 8 : 4)
    fused_pair_kernel(const FusedArgs a) {
  // every lane stays to the end: the walk's votes take the whole warp
  const int pos = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = pos < a.n;
  const int i = in ? a.order[pos] : 0;
  const Rec<T> di = in ? rec<T>(a.plane[kPos], pos) : Rec<T>{};
  const bool walks = in && di.d > T(0);
  const walk::Lane l = walk::lane_cell(a, walks ? a.cell[i] : 0, walks);

  T arho = 0, au = 0, av = 0, aw = 0;
  T ui = 0, vi = 0, wi = 0, rhoi = 0, rhoi2 = 0, pi = 0;
  if (walks) {
    const Rec<T> vel = rec<T>(a.plane[kVel], pos);
    const Rec<T> th = rec<T>(a.plane[kThermo], pos);
    ui = vel.a;
    vi = vel.b;
    wi = vel.c;
    rhoi = th.a;
    pi = th.b;
    rhoi2 = rhoi * rhoi > T(1e-30) ? rhoi * rhoi : T(1e-30);
  }
  const T c0 = T(a.c0), alpha = T(a.alpha), beta = T(a.beta);
  const T eps_fac = T(a.eps_fac), pi_ = T(kPi);

  auto body = [&](int k) {
    const Rec<T> pj = rec<T>(a.plane[kPos], k);
    const T hj = pj.d;
    if (!(hj > T(0))) return;
    const T xij = di.a - pj.a;
    const T yij = di.b - pj.b;
    const T zij = di.c - pj.c;
    const T r2 = xij * xij + yij * yij + zij * zij;

    const T rij = sqrt(r2);
    const T hij = T(0.5) * (di.d + hj);
    const T q = rij / hij;
    const T fac = a.dim == 3   ? T(1) / (pi_ * (hij * hij * hij))
                  : a.dim == 2 ? T(10) / (T(7) * pi_ * (hij * hij))
                               : T(2) / (T(3) * hij);
    const T t = T(2) - q;
    const T dwdq = q <= T(1)   ? T(-3) * q + T(2.25) * q * q
                   : q <= T(2) ? T(-0.75) * (t * t)
                               : T(0);
    const T dwdr = fac * dwdq / hij;
    const T rinv = rij > T(1e-12) ? T(1) / rij : T(0);
    const T dwx = dwdr * xij * rinv;
    const T dwy = dwdr * yij * rinv;
    const T dwz = dwdr * zij * rinv;

    const Rec<T> vel = rec<T>(a.plane[kVel], k);
    const Rec<T> th = rec<T>(a.plane[kThermo], k);
    const T uij = ui - vel.a;
    const T vij = vi - vel.b;
    const T wij = wi - vel.c;
    const T vdotx = uij * xij + vij * yij + wij * zij;
    const T vdotdw = uij * dwx + vij * dwy + wij * dwz;

    const T rhoj = th.a;
    const T rhoij = T(0.5) * (rhoi + rhoj);
    const T muij = hij * vdotx / (r2 + eps_fac * hij * hij);
    const T piij = vdotx < T(0)
                       ? (-alpha * c0 * muij + beta * muij * muij) / rhoij
                       : T(0);
    const T rhoj2 = rhoj * rhoj > T(1e-30) ? rhoj * rhoj : T(1e-30);
    const T pfac = pi / rhoi2 + th.b / rhoj2 + piij;

    arho += vdotdw;
    au -= pfac * dwx;
    av -= pfac * dwy;
    aw -= pfac * dwz;
  };
  walk::Walker<T> walker;
  walker.begin();
  walk::walk_rows(a, a.cell_start, a.cell_end, a.plane[kPos], l, 1, di,
                  T(2), walker, body);
  walker.finish(body);
  if (!in) return;
  static_cast<T*>(a.out[0])[i] = arho;
  static_cast<T*>(a.out[1])[i] = au;
  static_cast<T*>(a.out[2])[i] = av;
  static_cast<T*>(a.out[3])[i] = aw;
}

template <typename T>
cudaError_t launch(const FusedArgs& a, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (a.n + threads - 1) / threads;
  fused_pair_kernel<T><<<blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_pair_args_size() { return static_cast<int>(sizeof(FusedArgs)); }

int fused_pair_launch(const FusedArgs* args, void* stream) {
  const FusedArgs a = *args;
  if (a.nx < 1 || a.ny < 1 || a.nz < 1 || a.dim < 1 || a.dim > 3 ||
      (a.dtype != 0 && a.dtype != 1) || !pack::args_ok(a.pack) ||
      (a.pack.n_src != 0 && a.pack.dtype != a.dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t packed = pack::launch(a.pack, st);
  if (packed != cudaSuccess) return static_cast<int>(packed);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* fused_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
