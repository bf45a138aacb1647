// Deterministic sums across blocks. The TPU kernels carry a running
// sum in VMEM from one sequential grid step to the next; on the card
// blocks run in parallel in no order, so each reducing kernel here
// writes its block's partial sums to its own row of a scratch tensor
// (P rows of T floats, allocated by the wrapper) and sum_rows adds the
// rows in a fixed order. Same inputs, same bits, every run.
#pragma once

#include "common.cuh"

namespace {

constexpr int SR_X = 32, SR_Y = 32;

// out[e] = (sum over p < P of part[p * T + e]) / div. Block (32, 32):
// x walks 32 consecutive e (coalesced rows), y strides over the rows;
// the 32 stripes then add up in shared memory in stripe order.
__global__ void __launch_bounds__(SR_X * SR_Y)
sum_rows_kernel(const float* __restrict__ part, int P, int T, float div,
                float* __restrict__ out) {
  __shared__ float s[SR_Y][SR_X + 1];
  const int e = blockIdx.x * SR_X + threadIdx.x;
  float acc = 0.f;
  if (e < T)
    for (int p = threadIdx.y; p < P; p += SR_Y) acc += part[(long)p * T + e];
  s[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < T) {
    float t = 0.f;
    for (int y = 0; y < SR_Y; ++y) t += s[y][threadIdx.x];
    out[e] = t / div;
  }
}

static cudaError_t sum_rows(const float* part, int P, int T, float div,
                            float* out, cudaStream_t stream) {
  sum_rows_kernel<<<(T + SR_X - 1) / SR_X, dim3(SR_X, SR_Y), 0, stream>>>(
      part, P, T, div, out);
  return cudaGetLastError();
}

// Sum of v over a warp, same tree every call.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace
