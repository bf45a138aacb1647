// K5 conv_stats — the train zone's convolution with its batch
// statistics: stride-1, odd k x k 'same' convolution over an NHWC bf16
// tensor, f32 accumulation, + bias when given, stored as bf16 y, and
// per channel s1 = sum(y) and s2 = sum(y * y) over every pixel of the
// batch, taken on the stored bf16 values (f32 sums). No affine and no
// ReLU: train-mode BatchNorm needs the raw conv output and normalises
// from (s1, s2) alone.
//
// Replaces ubresnet_tpu/ops/pallas_train.py:train_conv_stats
// (_conv_stats_kernel), which accumulates the sums in VMEM across its
// sequential grid. Here each block walks a fixed, strided set of 16x16
// output tiles, keeps its pixels' sums in registers, reduces them over
// the block (warp shuffles, then the 8 warps in order) into its own row
// of a scratch tensor, and sum_rows (partials.cuh) adds the rows in
// order: the sums are the same bits on every run. The TPU kernel's
// W-packing and halo-combo blocks are not carried over.
//
// Bound on the H100: operations for the 3x3 and 7x7 layers (e.g.
// 9*32*32 MACs per 128 bytes of a (32,32,3) pixel's input and output,
// 144 op/B in f32 FMA terms, far above the ~21 op/B f32 ridge), bytes
// for the 1x1 projections. Design (first, simple form), as K1: the
// input tile with its halo and all weights sit in shared memory as f32
// (weights loaded once per block, not per tile), each thread
// accumulates one output pixel's CO channels with f32 FMAs. Tensor
// cores (mma/wgmma) are later work.
#include "common.cuh"
#include "partials.cuh"
#include "ubr_shapes.h"  // UBR_CONV_STATS_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 16, TW = 16, NT = TH * TW, NWARP = NT / 32;

template <int CI, int CO, int K>
struct StatsShape {
  static constexpr int R = K / 2;
  static constexpr int XH = TH + K - 1, XW = TW + K - 1;
  static constexpr int CIP = CI + 4;             // padded pixel stride
  static constexpr int COP = (CO + 3) / 4 * 4;   // float4-able outputs
  static constexpr int XS = XH * XW * CIP;       // floats
  static constexpr int WS = K * K * CI * COP;    // floats
  static constexpr int RS = NWARP * 2 * CO;      // per-warp sums
  static constexpr int SMEM = (WS + XS + RS) * 4;
};

template <int CI, int CO, int K>
__global__ void __launch_bounds__(NT)
conv_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ y,
                  float* __restrict__ part, int B, int H, int W) {
  using S = StatsShape<CI, CO, K>;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  float* xs = ws + S::WS;
  float* red = xs + S::XS;

  const int tid = threadIdx.x;
  const int ty = tid / TW, tx = tid % TW;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;

  for (int e = tid; e < S::WS; e += NT) {
    const int co = e % S::COP, row = e / S::COP;
    ws[e] = co < CO ? __bfloat162float(w[row * CO + co]) : 0.f;
  }
  float s1[CO], s2[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) s1[c] = s2[c] = 0.f;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / (tiles_h * tiles_w);
    const int rem = t % (tiles_h * tiles_w);
    const int oh0 = (rem / tiles_w) * TH, ow0 = (rem % tiles_w) * TW;
    __syncthreads();  // the previous tile's reads of xs are done
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
    if (oh < H && ow < W) {
      const long base = (((long)b * H + oh) * W + ow) * CO;
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float v = bias != nullptr ? acc[c] + __ldg(bias + c) : acc[c];
        const bf16 q = __float2bfloat16(v);
        y[base + c] = q;
        const float f = __bfloat162float(q);  // sums of the emitted y
        s1[c] += f;
        s2[c] = fmaf(f, f, s2[c]);
      }
    }
  }

  // block sums: each warp's tree, then the warps in order
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int c = 0; c < CO; ++c) {
    const float a = warp_sum(s1[c]), q = warp_sum(s2[c]);
    if (lane == 0) {
      red[warp * 2 * CO + c] = a;
      red[warp * 2 * CO + CO + c] = q;
    }
  }
  __syncthreads();
  if (tid < 2 * CO) {
    float t = 0.f;
    for (int wp = 0; wp < NWARP; ++wp) t += red[wp * 2 * CO + tid];
    part[(long)blockIdx.x * 2 * CO + tid] = t;
  }
}

template <int CI, int CO, int K>
int launch(const void* x, const void* w, const void* bias, void* y,
           void* part, void* sums, int B, int H, int W, int blocks,
           cudaStream_t stream) {
  using S = StatsShape<CI, CO, K>;
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(conv_stats_kernel<CI, CO, K>, S::SMEM, &smem_set);
  if (e != cudaSuccess) return (int)e;
  conv_stats_kernel<CI, CO, K><<<blocks, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y),
      static_cast<float*>(part), B, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(static_cast<const float*>(part), blocks, 2 * CO, 1.f,
                       static_cast<float*>(sums), stream);
}

}  // namespace

// (ci, co, k) instantiated: UBR_CONV_STATS_SHAPES, from the one table in
// ops/_build.py:SHAPES. sums is (2*co,) f32: s1 then s2; part is the
// wrapper's (blocks, 2*co) f32 scratch.
UBR_EXPORT int ubr_conv_stats(const void* x, const void* w, const void* bias,
                              void* y, void* part, void* sums, int B, int H,
                              int W, int ci, int co, int k, int blocks,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
#define UBR_STATS(CI, CO, K)                                               \
  if (ci == CI && co == CO && k == K)                                      \
    return launch<CI, CO, K>(x, w, bias, y, part, sums, B, H, W, blocks, s);
  UBR_CONV_STATS_SHAPES(UBR_STATS)
#undef UBR_STATS
  return (int)cudaErrorInvalidValue;
}
