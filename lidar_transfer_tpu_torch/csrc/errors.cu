// Error text for the cudaError_t codes the kernel entries return, and an
// empty kernel: the yardstick of what one launch costs on the device.

#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" const char* lt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one empty block on the stream. Returns the cudaError_t.
extern "C" int lt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
