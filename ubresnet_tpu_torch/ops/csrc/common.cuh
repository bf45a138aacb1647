// Shared helpers of the port's Hopper kernels (NHWC, bf16 activations,
// f32 accumulation). Every entry point is extern "C", launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

#define UBR_EXPORT extern "C" __attribute__((visibility("default")))

// Two consecutive bf16 values from shared memory as floats.
__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const bf162*>(p));
}

// Raise a kernel's dynamic shared-memory limit once (launches above
// 48 KB are refused otherwise, and only cudaGetLastError() says so).
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *done = true;
  return e;
}
