// Gather probe of the compact engine's grid spec, for Hopper (sm_90a).
//
// Replaces tools_dev/micro_engine.py::kern, the Pallas mock of
// pysph_tpu/ops/pallas_engine.py::_pair_kernel_compact's grid spec with
// the pair arithmetic taken out.  Program a (an active cell block) reads
// n_views neighbour views of each of n_src source packs and computes
//
//   acc[t] = sum_si sum_views sum_l src[si, blk(si, view, a), 0, t, l]
//   out[a, po, t, m] = acc[t]            for po < 5, m < md
//
// where the block of view (oy, ox) of source si is, with dyn_maps,
// inv[si][(clip(bi[a] + ox, 0, nx-1) * ny + clip(bj[a] + oy, 0, ny-1))
// * n_zt + bz[a]] (the engine's scalar-prefetched cell lookup) and else
// the static (a * 7 + ox * 3 + oy + si) mod n_sblocks.  The views are
// (oy, ox) for oy, ox in -1, 0, 1, oy major, cut to n_views.
//
// What bounds it: the gather of plane 0 of each view (tz * lanes floats,
// 3 KB at the fluid's shapes) through an index that the block first
// reads; at most n_sblocks + 1 distinct blocks of each source are
// reachable, so the unique bytes are a few MB and the bound is far under
// the time of a launch.  The TPU kernel also moved the dest pack and
// every plane of each view; this function reads neither, since neither
// reaches the output.  The TPU flags `scratch` and `when_gate` only
// change how the TPU writes the same function and have no counterpart.
//
// Design: one block of 256 threads per program; warp w sums row t = w
// (and t + 8, ...) over every view, its lanes striding the row, then a
// shuffle reduction; the block then writes the 5 * tz * md outputs from
// shared memory, coalesced.
//
// Interface: plain C through ctypes (ops/micro.py).  micro_engine_launch
// takes a host pointer to MicroEngineArgs and the stream, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

struct MicroEngineArgs {
  const float* src;             // (n_src, n_sblocks + 1, planes, tz, lanes)
  const int32_t *bi, *bj, *bz;  // (a_max,) block coordinates
  const int32_t* inv;           // (n_src, b) cell -> source block
  float* out;                   // (a_max, 5, tz, md)
  int32_t a_max, n_src, n_sblocks, planes, tz, lanes, md, n_views,
      dyn_maps, nx, ny, n_zt, b, pad;
};

namespace {

constexpr int kThreads = 256, kOutPlanes = 5;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : v > hi ? hi : v;
}

__global__ void __launch_bounds__(kThreads)
    micro_engine_kernel(const MicroEngineArgs a) {
  extern __shared__ float sacc[];  // (tz,)
  const int prog = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long blk_stride = 1LL * a.planes * a.tz * a.lanes;
  const long long src_stride = (a.n_sblocks + 1LL) * blk_stride;
  for (int t = warp; t < a.tz; t += kThreads / 32) {
    float acc = 0.f;
    for (int si = 0; si < a.n_src; ++si) {
      for (int v = 0; v < a.n_views; ++v) {
        const int oy = v / 3 - 1, ox = v % 3 - 1;
        int blk;
        if (a.dyn_maps) {
          const int i2 = clampi(a.bi[prog] + ox, 0, a.nx - 1);
          const int j2 = clampi(a.bj[prog] + oy, 0, a.ny - 1);
          blk = a.inv[si * a.b + (i2 * a.ny + j2) * a.n_zt + a.bz[prog]];
        } else {
          blk = (7 * prog + 3 * ox + oy + si) % a.n_sblocks;
          if (blk < 0) blk += a.n_sblocks;  // Python's mod
        }
        const float* row =
            a.src + si * src_stride + blk * blk_stride + 1LL * t * a.lanes;
        for (int l = lane; l < a.lanes; l += 32) acc += row[l];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) sacc[t] = acc;
  }
  __syncthreads();
  const int per = a.tz * a.md;
  float* out = a.out + 1LL * prog * kOutPlanes * per;
  for (int k = threadIdx.x; k < kOutPlanes * per; k += kThreads)
    out[k] = sacc[(k % per) / a.md];
}

}  // namespace

extern "C" {

int micro_engine_args_size() {
  return static_cast<int>(sizeof(MicroEngineArgs));
}

int micro_engine_launch(const MicroEngineArgs* args, void* stream) {
  const MicroEngineArgs a = *args;
  if (a.a_max < 0 || a.n_src < 0 || a.n_sblocks < 1 || a.planes < 1 ||
      a.tz < 1 || a.tz > 4096 || a.lanes < 1 || a.md < 1 || a.n_views < 0 ||
      a.n_views > 9 || a.nx < 1 || a.ny < 1 || a.n_zt < 1 ||
      1LL * a.nx * a.ny * a.n_zt > a.b)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.a_max == 0) return 0;
  micro_engine_kernel<<<a.a_max, kThreads, a.tz * sizeof(float),
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* micro_engine_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
