// C entry point shared by every kernel wrapper: the message of a CUDA
// error code returned by a launch.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
