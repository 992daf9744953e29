// Error text for the cudaError_t codes the kernel entries return.

#include <cuda_runtime.h>

extern "C" const char* lt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
