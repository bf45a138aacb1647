// K1 conv_bn_act — stride-1, odd k x k 'same' convolution over an NHWC
// bf16 tensor, f32 accumulation, then the eval epilogue
//   y = acc * g + b -> [ReLU] (pre-add) -> [+ residual] -> [ReLU]
// stored as bf16.
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:fused_packed_conv
// (_conv_kernel): the UResNet head conv10 (7x7 16->16 + bias + BN +
// ReLU) and classifier conv11 (7x7 16->3 + bias, g = 1, no ReLU) at the
// full crop resolution. The TPU kernel's W-packing and halo-combo
// blocks exist only to fill 128-lane tiles and are not carried over.
//
// Bound on the H100: operations. 7x7x16x16 MACs per output pixel is
// 25,088 operations per 64 bytes moved (392 op/B), above the card's
// ~295 op/B bf16 ridge. Design (first, simple form): one block computes a 16x16
// output tile; the input tile with its (k-1)-pixel halo and all the
// weights sit in shared memory as f32 (the input read once per block,
// zero-filled outside the image), and each thread accumulates one
// output pixel's CO channels in registers with f32 FMAs. Weights are
// read as 16-byte broadcasts shared by the whole warp, inputs as
// 16-byte vectors from a padded pixel stride that keeps the
// per-thread reads free of bank conflicts. Tensor cores (mma/wgmma)
// are the next step, not this one.
#include "common.cuh"
#include "ubr_shapes.h"  // UBR_CONV_BN_ACT_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 16, TW = 16, NT = TH * TW;

template <int CI, int CO, int K>
struct ConvShape {
  static constexpr int R = K / 2;
  static constexpr int XH = TH + K - 1, XW = TW + K - 1;
  static constexpr int CIP = CI + 4;               // padded pixel stride
  static constexpr int COP = (CO + 3) / 4 * 4;     // float4-able outputs
  static constexpr int XS = XH * XW * CIP;         // floats
  static constexpr int WS = K * K * CI * COP;      // floats
  static constexpr int SMEM = (XS + WS) * 4;
};

template <int CI, int CO, int K>
__global__ void __launch_bounds__(NT)
conv_bn_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ g, const float* __restrict__ bias,
                   const bf16* __restrict__ res, bf16* __restrict__ out,
                   int H, int W, int pre_act, int act) {
  using S = ConvShape<CI, CO, K>;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + S::WS;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oh0 = blockIdx.y * TH, ow0 = blockIdx.x * TW;

  // weights (k, k, ci, co) bf16 -> f32 [tap][ci][COP], zero-padded co
  for (int e = tid; e < S::WS; e += NT) {
    const int co = e % S::COP, row = e / S::COP;
    ws[e] = co < CO ? __bfloat162float(w[row * CO + co]) : 0.f;
  }
  // input tile with halo, zero outside the image ('same' padding)
  for (int e = tid; e < S::XH * S::XW * CI; e += NT) {
    const int c = e % CI, pix = e / CI;
    const int ih = oh0 - S::R + pix / S::XW;
    const int iw = ow0 - S::R + pix % S::XW;
    float v = 0.f;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = __bfloat162float(x[(((long)b * H + ih) * W + iw) * CI + c]);
    xs[pix * S::CIP + c] = v;
  }
  __syncthreads();

  const int ty = tid / TW, tx = tid % TW;
  float acc[S::COP];
#pragma unroll
  for (int c = 0; c < S::COP; ++c) acc[c] = 0.f;

  for (int kh = 0; kh < K; ++kh) {
#pragma unroll 1
    for (int kw = 0; kw < K; ++kw) {
      const float* xp = xs + ((ty + kh) * S::XW + tx + kw) * S::CIP;
      const float* wp = ws + (kh * K + kw) * CI * S::COP;
#pragma unroll
      for (int ci = 0; ci < CI; ci += 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xp + ci);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4* wr =
              reinterpret_cast<const float4*>(wp + (ci + j) * S::COP);
#pragma unroll
          for (int c4 = 0; c4 < S::COP / 4; ++c4) {
            const float4 wv = wr[c4];
            acc[4 * c4 + 0] = fmaf(xa[j], wv.x, acc[4 * c4 + 0]);
            acc[4 * c4 + 1] = fmaf(xa[j], wv.y, acc[4 * c4 + 1]);
            acc[4 * c4 + 2] = fmaf(xa[j], wv.z, acc[4 * c4 + 2]);
            acc[4 * c4 + 3] = fmaf(xa[j], wv.w, acc[4 * c4 + 3]);
          }
        }
      }
    }
  }

  const int oh = oh0 + ty, ow = ow0 + tx;
  if (oh >= H || ow >= W) return;
  const long base = (((long)b * H + oh) * W + ow) * CO;
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    float y = acc[c] * __ldg(g + c) + __ldg(bias + c);
    if (pre_act) y = fmaxf(y, 0.f);
    if (res != nullptr) y += __bfloat162float(res[base + c]);
    if (act) y = fmaxf(y, 0.f);
    out[base + c] = __float2bfloat16(y);
  }
}

template <int CI, int CO, int K>
int launch(const void* x, const void* w, const void* g, const void* b,
           const void* res, void* out, int B, int H, int W, int pre_act,
           int act, cudaStream_t stream) {
  using S = ConvShape<CI, CO, K>;
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(conv_bn_act_kernel<CI, CO, K>, S::SMEM, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv_bn_act_kernel<CI, CO, K><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const bf16*>(res), static_cast<bf16*>(out), H, W, pre_act,
      act);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co, k) instantiated: UBR_CONV_BN_ACT_SHAPES, from the one table
// in ops/_build.py:SHAPES.
UBR_EXPORT int ubr_conv_bn_act(const void* x, const void* w, const void* g,
                               const void* b, const void* res, void* out,
                               int B, int H, int W, int ci, int co, int k,
                               int pre_act, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_CONV(CI, CO, K)                                                \
  if (ci == CI && co == CO && k == K)                                      \
    return launch<CI, CO, K>(x, w, g, b, res, out, B, H, W, pre_act, act, s);
  UBR_CONV_BN_ACT_SHAPES(UBR_CONV)
#undef UBR_CONV
  return (int)cudaErrorInvalidValue;
}
