// Error strings for the status codes the kernel entry points return.
#include "common.cuh"

extern "C" const char* repro_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
