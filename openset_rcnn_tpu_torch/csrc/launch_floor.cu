// An empty kernel: the floor under every kernel's time on the card.
//
// Not a port of a TPU kernel. chip_smoke.py times it, back to back and under
// the profiler, at one block and at the grids of the small kernels (K3, K4
// pass 1), so that the launch cost stands beside bounds that lie below it.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// One launch of `blocks` x `threads` on `stream`; returns cudaGetLastError().
int empty_launch(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024) return (int)cudaErrorInvalidValue;
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
