// Shared C entry point of the kernel library: the text of a cudaError_t
// that a launch entry point returned (the Python wrappers raise with it).

#include <cuda_runtime.h>

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
