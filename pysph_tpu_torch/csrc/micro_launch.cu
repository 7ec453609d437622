// Launch and per-view gather probe for Hopper (sm_90a).
//
// Replaces tools_dev/micro_launch.py::kern, the Pallas probe of program
// launches and per-view DMA.  It computes
//
//   out[a, 0, t, l] = sum_v sum_p src[(a * 7 + v * 3) % n_blocks, p, t, l]
//
// for a < n_programs, t < tz, l < 8: each program sums n_views views of
// (planes, tz, lanes) floats, picked by a fixed pseudo-random map, and
// keeps the first 8 lanes.
//
// What bounds it: at the tool's shapes nothing on the card.  The views
// reach at most n_blocks distinct blocks and each program writes tz * 8
// floats, so the unique bytes are a few MB (well under a microsecond at
// 3.35 TB/s), and the sums are a few million adds.  The time is that of
// a launch and of the latency of one gather per view, which is what the
// probe is for.  Only the first 8 lanes of a view reach the output, so a
// GPU kernel reads planes * tz * 8 floats of each view, not the whole
// view as the TPU's DMA did: bytes per view are not the TPU tool's.
//
// Design: one block per program, one thread per output (t, l), tz * 8
// threads; each thread loops over the views and planes and loads one
// float per (view, plane).  A warp covers four rows of 8 lanes: four
// 32-byte segments per load.
//
// Interface: plain C through ctypes (ops/micro.py).  micro_launch_launch
// takes a host pointer to MicroLaunchArgs and the stream, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

struct MicroLaunchArgs {
  const float* src;  // (n_blocks, planes, tz, lanes)
  float* out;        // (n_programs, 1, tz, 8)
  int32_t n_programs, n_views, planes, tz, lanes, n_blocks;
};

namespace {

constexpr int kOutLanes = 8;

__global__ void micro_launch_kernel(const MicroLaunchArgs a) {
  const int prog = blockIdx.x;
  const int t = threadIdx.x / kOutLanes, l = threadIdx.x % kOutLanes;
  const long long view = 1LL * a.planes * a.tz * a.lanes;
  float acc = 0.f;
  for (int v = 0; v < a.n_views; ++v) {
    const long long blk = (7LL * prog + 3LL * v) % a.n_blocks;
    const float* p = a.src + blk * view + 1LL * t * a.lanes + l;
    for (int pl = 0; pl < a.planes; ++pl) acc += p[1LL * pl * a.tz * a.lanes];
  }
  a.out[(1LL * prog * a.tz + t) * kOutLanes + l] = acc;
}

}  // namespace

extern "C" {

int micro_launch_args_size() {
  return static_cast<int>(sizeof(MicroLaunchArgs));
}

int micro_launch_launch(const MicroLaunchArgs* args, void* stream) {
  const MicroLaunchArgs a = *args;
  if (a.n_programs < 0 || a.n_views < 0 || a.planes < 1 || a.tz < 1 ||
      a.tz * kOutLanes > 1024 || a.lanes < kOutLanes || a.n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_programs == 0) return 0;
  micro_launch_kernel<<<a.n_programs, a.tz * kOutLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* micro_launch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
