// K1-s8 conv_bn_act_s8 — the int8 mode of K1: stride-1, odd k x k 'same'
// convolution of an NHWC int8 tensor with an int8 (k, k, ci, co) kernel,
// exact s32 accumulation, then the eval epilogue in float32
//   y = f32(acc) * g + b -> [ReLU] (pre-add) -> [+ residual] -> [ReLU]
// stored as bf16 (the model) or float (checks). g carries the dequant
// scale sx * sw folded into the BN gain (ops/quant.py).
//
// Replaces the quantized=True mode of
// ubresnet_tpu/ops/pallas_conv.py:fused_packed_conv (_conv_kernel): the
// UResNet head conv10 (7x7 16->16 + bias + BN + ReLU) under int8 deploy.
//
// Bound on the H100: bytes at the int8 tensor-core peak (7x7x16x16 MACs
// per output pixel against 16 + 32 bytes moved is 523 op/B, just under
// the ~590 op/B int8 ridge), but this first form runs __dp4a on the
// CUDA cores, so in practice operations bind it. Design (as K1): one block
// computes a 16x16 output tile; the int8 input tile with its (k-1)-pixel
// halo and all the weights sit in shared memory — the weights pre-packed
// as __dp4a operands (4 input channels of one output channel per word)
// and read as warp-wide 16-byte broadcasts, the input at an odd 16-byte
// pixel stride (conflict-free 16-byte reads); each thread accumulates one
// output pixel's CO channels in s32 registers with __dp4a. Tensor-core
// int8 MMA is the next step, not this one.
#include "common.cuh"
#include "ubr_shapes.h"  // UBR_CONV_BN_ACT_S8_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 16, TW = 16, NT = TH * TW;

template <int CI, int CO, int K>
struct ConvS8Shape {
  static_assert(CI % 16 == 0 && CO % 8 == 0, "int8 conv channel grain");
  static constexpr int R = K / 2;
  static constexpr int XH = TH + K - 1, XW = TW + K - 1;
  static constexpr int CG = CI / 4;             // input words per pixel
  static constexpr int XWD = s8_words(CI);      // padded pixel stride
  static constexpr int WS = K * K * CG * CO;    // weight words
  static constexpr int XS = XH * XW * XWD;      // input words
  static constexpr int SMEM = (WS + XS) * 4;
};

template <int CI, int CO, int K, typename OT>
__global__ void __launch_bounds__(NT)
conv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ g, const float* __restrict__ bias,
               const OT* __restrict__ res, OT* __restrict__ out, int H, int W,
               int pre_act, int act) {
  using S = ConvS8Shape<CI, CO, K>;
  extern __shared__ int4 smem_s8[];
  int* ws = reinterpret_cast<int*>(smem_s8);
  int* xs = ws + S::WS;

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int oh0 = blockIdx.y * TH, ow0 = blockIdx.x * TW;

  // weights (k, k, ci, co) -> words [tap][ci / 4][co]
  for (int e = tid; e < S::WS; e += NT) {
    const int co = e % CO, row = e / CO;
    const int cg = row % S::CG, tap = row / S::CG;
    ws[e] = pack_s8x4(w + ((long)tap * CI + 4 * cg) * CO + co, CO);
  }
  // input tile with halo, zero outside the image ('same' padding)
  for (int e = tid; e < S::XH * S::XW * S::CG; e += NT) {
    const int cg = e % S::CG, pix = e / S::CG;
    const int ih = oh0 - S::R + pix / S::XW;
    const int iw = ow0 - S::R + pix % S::XW;
    int v = 0;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = *reinterpret_cast<const int*>(
          x + (((long)b * H + ih) * W + iw) * CI + 4 * cg);
    xs[pix * S::XWD + cg] = v;
  }
  __syncthreads();

  const int ty = tid / TW, tx = tid % TW;
  int acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0;

  for (int kh = 0; kh < K; ++kh) {
#pragma unroll 1
    for (int kw = 0; kw < K; ++kw) {
      const int* xp = xs + ((ty + kh) * S::XW + tx + kw) * S::XWD;
      const int* wp = ws + (kh * K + kw) * S::CG * CO;
#pragma unroll
      for (int c16 = 0; c16 < S::CG; c16 += 4) {
        const int4 xv = *reinterpret_cast<const int4*>(xp + c16);
        const int xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int4* wr = reinterpret_cast<const int4*>(wp + (c16 + j) * CO);
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const int4 wv = wr[q];
            acc[4 * q + 0] = __dp4a(xa[j], wv.x, acc[4 * q + 0]);
            acc[4 * q + 1] = __dp4a(xa[j], wv.y, acc[4 * q + 1]);
            acc[4 * q + 2] = __dp4a(xa[j], wv.z, acc[4 * q + 2]);
            acc[4 * q + 3] = __dp4a(xa[j], wv.w, acc[4 * q + 3]);
          }
        }
      }
    }
  }

  const int oh = oh0 + ty, ow = ow0 + tx;
  if (oh >= H || ow >= W) return;
  const long base = (((long)b * H + oh) * W + ow) * CO;
  float y[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    y[c] = affine_fma(acc[c], __ldg(g + c), __ldg(bias + c));
    if (pre_act) y[c] = fmaxf(y[c], 0.f);
    if (res != nullptr) y[c] = __fadd_rn(y[c], to_f32(res[base + c]));
    if (act) y[c] = fmaxf(y[c], 0.f);
  }
  store_px<CO>(out + base, y);
}

template <int CI, int CO, int K, typename OT>
int launch(const void* x, const void* w, const void* g, const void* b,
           const void* res, void* out, int B, int H, int W, int pre_act,
           int act, cudaStream_t stream) {
  using S = ConvS8Shape<CI, CO, K>;
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(conv_s8_kernel<CI, CO, K, OT>, S::SMEM, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv_s8_kernel<CI, CO, K, OT><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const OT*>(res), static_cast<OT*>(out), H, W, pre_act,
      act);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co, k) instantiated: UBR_CONV_BN_ACT_S8_SHAPES, from the one
// table in ops/_build.py:SHAPES; out_f32 selects a float output (and
// residual) instead of bf16.
UBR_EXPORT int ubr_conv_bn_act_s8(const void* x, const void* w,
                                  const void* g, const void* b,
                                  const void* res, void* out, int B, int H,
                                  int W, int ci, int co, int k, int pre_act,
                                  int act, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_CONV_S8(CI, CO, K)                                               \
  if (ci == CI && co == CO && k == K)                                        \
    return out_f32 ? launch<CI, CO, K, float>(x, w, g, b, res, out, B, H, W, \
                                              pre_act, act, s)               \
                   : launch<CI, CO, K, bf16>(x, w, g, b, res, out, B, H, W,  \
                                             pre_act, act, s);
  UBR_CONV_BN_ACT_S8_SHAPES(UBR_CONV_S8)
#undef UBR_CONV_S8
  return (int)cudaErrorInvalidValue;
}
