// Shared C entry points of libkernels.so that belong to no single kernel.
#include <cuda_runtime.h>

// Name of a cudaError_t code, for the Python wrappers' error messages.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
