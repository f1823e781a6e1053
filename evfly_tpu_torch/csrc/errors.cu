// Error text for the status codes that the kernels' C entry points return.

#include <cuda_runtime.h>

extern "C" const char* evfly_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
