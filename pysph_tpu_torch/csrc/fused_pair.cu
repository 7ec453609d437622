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
// What bounds it: like csrc/wcsph_pair.cu, the neighbour gather (9 values
// per candidate through the cell-sorted index, against ~60 flops).
//
// Design: one thread per dest particle walks the 3^dim cells around its
// own cell of the sorted cell list (ops/fused_pair.py takes per-particle
// tensors and the CellList, not the TPU's dense slot arrays), and
// accumulates in registers; no atomics, so runs repeat exactly.
//
// Interface: plain C through ctypes (ops/fused_pair.py):
// fused_pair_launch(const FusedArgs*, stream) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

struct FusedArgs {
  const void *x, *y, *z, *u, *v, *w, *h, *rho, *p;
  const int32_t* cell;        // cell id, ix + nx * (iy + ny * iz)
  const int32_t* order;       // particle indices sorted by cell
  const int32_t* cell_start;  // per cell: first position in order
  const int32_t* cell_end;    // per cell: one past the last
  void* out[4];               // arho, au, av, aw
  double c0, alpha, beta, eps_fac;
  int32_t n, nx, ny, nz, dim, dtype;
};

namespace {

constexpr double kPi = 3.14159265358979323846;

template <typename T>
__device__ __forceinline__ T ld(const void* p, int i) {
  return static_cast<const T*>(p)[i];
}

template <typename T>
__global__ void __launch_bounds__(128) fused_pair_kernel(const FusedArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;

  T arho = 0, au = 0, av = 0, aw = 0;
  const T hi = ld<T>(a.h, i);
  if (hi > T(0)) {
    const T xi = ld<T>(a.x, i), yi = ld<T>(a.y, i), zi = ld<T>(a.z, i);
    const T ui = ld<T>(a.u, i), vi = ld<T>(a.v, i), wi = ld<T>(a.w, i);
    const T rhoi = ld<T>(a.rho, i);
    const T rhoi2 = rhoi * rhoi > T(1e-30) ? rhoi * rhoi : T(1e-30);
    const T pi = ld<T>(a.p, i);
    const T c0 = T(a.c0), alpha = T(a.alpha), beta = T(a.beta);
    const T eps_fac = T(a.eps_fac), pi_ = T(kPi);

    const int c = a.cell[i];
    const int cx = c % a.nx, cy = (c / a.nx) % a.ny, cz = c / (a.nx * a.ny);
    const int rx = a.nx > 1, ry = a.ny > 1, rz = a.nz > 1;
    for (int oz = -rz; oz <= rz; ++oz) {
      const int z = cz + oz;
      if (z < 0 || z >= a.nz) continue;
      for (int oy = -ry; oy <= ry; ++oy) {
        const int y = cy + oy;
        if (y < 0 || y >= a.ny) continue;
        for (int ox = -rx; ox <= rx; ++ox) {
          const int x = cx + ox;
          if (x < 0 || x >= a.nx) continue;
          const int nc = x + a.nx * (y + a.ny * z);
          const int kend = a.cell_end[nc];
          for (int k = a.cell_start[nc]; k < kend; ++k) {
            const int j = a.order[k];
            const T hj = ld<T>(a.h, j);
            if (!(hj > T(0))) continue;
            const T xij = xi - ld<T>(a.x, j);
            const T yij = yi - ld<T>(a.y, j);
            const T zij = zi - ld<T>(a.z, j);
            const T r2 = xij * xij + yij * yij + zij * zij;
            const T sup = T(2) * (hi > hj ? hi : hj);
            if (!(r2 < sup * sup)) continue;

            const T rij = sqrt(r2);
            const T hij = T(0.5) * (hi + hj);
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

            const T uij = ui - ld<T>(a.u, j);
            const T vij = vi - ld<T>(a.v, j);
            const T wij = wi - ld<T>(a.w, j);
            const T vdotx = uij * xij + vij * yij + wij * zij;
            const T vdotdw = uij * dwx + vij * dwy + wij * dwz;

            const T rhoj = ld<T>(a.rho, j);
            const T rhoij = T(0.5) * (rhoi + rhoj);
            const T muij = hij * vdotx / (r2 + eps_fac * hij * hij);
            const T piij = vdotx < T(0)
                               ? (-alpha * c0 * muij + beta * muij * muij) /
                                     rhoij
                               : T(0);
            const T rhoj2 = rhoj * rhoj > T(1e-30) ? rhoj * rhoj : T(1e-30);
            const T pfac = pi / rhoi2 + ld<T>(a.p, j) / rhoj2 + piij;

            arho += vdotdw;
            au -= pfac * dwx;
            av -= pfac * dwy;
            aw -= pfac * dwz;
          }
        }
      }
    }
  }
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
      (a.dtype != 0 && a.dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(a.dtype == 0 ? launch<float>(a, st)
                                        : launch<double>(a, st));
}

const char* fused_pair_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
