// Error text for the codes the launch functions return.
#include <cuda_runtime.h>

extern "C" const char* tl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
