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

// ---- int8 kernels (K1-s8, K2-s8, K3-s8): s8 x s8 -> s32 on the tensor
// cores (tensor_core.cuh:mma_s8), float32 epilogues in the JAX package's
// order, each affine acc * g + b one fused multiply-add (rounded once, as
// XLA compiles that expression; the plain PyTorch versions round it once
// through float64, ops/quant.py:fma), output bf16 or float.

// f32(acc) * g + b, rounded once.
__device__ __forceinline__ float affine_fma(int acc, float g, float b) {
  return __fmaf_rn(__int2float_rn(acc), g, b);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Two float32 values stored as a bf16 or float pair.
__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<bf162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
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
