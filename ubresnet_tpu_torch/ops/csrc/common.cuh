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

// ---- int8 kernels (K1-s8, K2-s8, K3-s8): s8 x s8 -> s32 (K1-s8 and
// K3-s8 with __dp4a over 4-channel groups, K2-s8 on the tensor cores:
// tensor_core.cuh:mma_s8), float32 epilogues in the JAX package's order,
// each affine acc * g + b one fused multiply-add (rounded once, as XLA
// compiles that expression; the plain PyTorch versions round it once
// through float64, ops/quant.py:fma), output bf16 or float.

// Words (4 int8 channels each) per pixel of an int8 tile in shared
// memory: c/4 padded to an odd number of 16-byte units, so the 16-byte
// per-thread reads of neighbouring pixels hit distinct banks.
__host__ __device__ constexpr int s8_words(int c) {
  return (c / 16) % 2 ? c / 4 : c / 4 + 4;
}

// Four int8 weights w[0], w[stride], w[2 stride], w[3 stride] packed
// into one __dp4a operand (channel 4g + i in byte i, as an int8 pixel
// holds its channels in memory).
__device__ __forceinline__ int pack_s8x4(const int8_t* w, int stride) {
  return (int)(uint8_t)w[0] | ((int)(uint8_t)w[stride] << 8) |
         ((int)(uint8_t)w[2 * stride] << 16) |
         ((int)(uint8_t)w[3 * stride] << 24);
}

// f32(acc) * g + b, rounded once.
__device__ __forceinline__ float affine_fma(int acc, float g, float b) {
  return __fmaf_rn(__int2float_rn(acc), g, b);
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Store N float32 values (one pixel's channels, 16-byte aligned) as bf16
// or float with 16-byte vector stores; N % 8 == 0.
template <int N>
__device__ __forceinline__ void store_px(bf16* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    uint4 u;
    bf162* h = reinterpret_cast<bf162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
    *reinterpret_cast<uint4*>(p + i) = u;
  }
}
template <int N>
__device__ __forceinline__ void store_px(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
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
