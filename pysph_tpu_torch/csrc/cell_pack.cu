// The source pack of csrc/cell_pack.cuh launched on its own, for Hopper
// (sm_90a): the entry of ops/wcsph_pair.py::pack_sources, which the tests
// and chip_smoke.py hold against its plain version.  On the paths the
// walks' launch functions launch the same kernel before their walk.
//
// Interface: plain C through ctypes.  cell_pack_launch takes a host
// pointer to PackArgs and the stream, and returns cudaGetLastError().

#include "cell_pack.cuh"

extern "C" {

int cell_pack_args_size() { return static_cast<int>(sizeof(PackArgs)); }

int cell_pack_launch(const PackArgs* args, void* stream) {
  const PackArgs a = *args;
  if (!pack::args_ok(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(pack::launch(a, st));
}

const char* cell_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
