// Error text for the codes the kernels' C entry points return.
#include "common.cuh"

extern "C" const char* chtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
