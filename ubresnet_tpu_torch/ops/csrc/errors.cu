// Error text for the codes the entry points return.
#include "common.cuh"

UBR_EXPORT const char* ubr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
