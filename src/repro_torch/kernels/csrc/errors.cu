// The CUDA runtime's text for an error code, for the Python wrappers' messages.
#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
