// K4 maxpool3x3s2 — torch MaxPool2d(3, stride=2, padding=1) over an
// NHWC bf16 tensor.
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:fused_pool3x3s2 (the UResNet
// stem pool). The TPU kernel pads with zero, which equals -inf padding
// on its non-negative (post-ReLU) domain; this kernel takes the max
// over the in-bounds taps only, i.e. -inf padding, exact for any input.
//
// Bound on the H100: bytes. It reads the input once (each input pixel
// sits in at most 4 windows, served from L1/L2) and writes a quarter
// of it; the 8 comparisons per output value are noise. Design: one
// thread per (output pixel, 8 channels) loads each tap as one 16-byte
// vector and reduces with bf16x2 max, so neighbouring threads touch
// neighbouring 16-byte words and the W-major window walk stays
// coalesced. The result is bit-exact (max does not round).
#include "common.cuh"

__global__ void maxpool3x3s2_kernel(const bf16* __restrict__ x,
                                    bf16* __restrict__ out, int B, int H,
                                    int W, int C, int Ho, int Wo) {
  const int groups = C / 8;
  const long total = (long)B * Ho * Wo * groups;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int g = (int)(i % groups);
  long p = i / groups;
  const int ow = (int)(p % Wo);
  p /= Wo;
  const int oh = (int)(p % Ho);
  const int b = (int)(p / Ho);

  const float ninf = __int_as_float(0xff800000);  // -inf
  __align__(16) bf162 m[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) m[j] = __floats2bfloat162_rn(ninf, ninf);
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int ih = 2 * oh + dy;
    if (ih < 0 || ih >= H) continue;
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int iw = 2 * ow + dx;
      if (iw < 0 || iw >= W) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + (((long)b * H + ih) * W + iw) * C + g * 8);
      const bf162* pv = reinterpret_cast<const bf162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) m[j] = __hmax2(m[j], pv[j]);
    }
  }
  *reinterpret_cast<uint4*>(out + (((long)b * Ho + oh) * Wo + ow) * C +
                            g * 8) = *reinterpret_cast<const uint4*>(m);
}

UBR_EXPORT int ubr_maxpool3x3s2(const void* x, void* out, int B, int H,
                                int W, int C, void* stream) {
  if (C % 8) return (int)cudaErrorInvalidValue;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const long total = (long)B * Ho * Wo * (C / 8);
  const int threads = 256;
  const long blocks = (total + threads - 1) / threads;
  maxpool3x3s2_kernel<<<(unsigned)blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), B, H, W, C, Ho,
      Wo);
  return (int)cudaGetLastError();
}
