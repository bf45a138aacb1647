// K8 conv_s2k4 — input gradient of ConvTranspose2d(k=4, stride=2,
// padding=1): the stride-2, k4, pad-1 cross-correlation
//   dx[b, i, j, ci] = sum over kr, kc, co of
//                     w[kr, kc, ci, co] * dy[b, 2i + kr - 1, 2j + kc - 1, co]
// with zeros outside dy, NHWC bf16 dy (B, 2H, 2W, co), the deconv's own
// kernel w (4, 4, ci, co) bf16 (no transpose, no flip), f32 accumulation,
// bf16 dx (B, H, W, ci).
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:fused_conv_s2k4 (_s2k4_kernel,
// s2k4_weights, _S2_TAPS), the dx leg of pallas_deconv2x_ad. The TPU form
// splits dy into row-parity planes packed 2p pixels to a 128-lane row
// and adds halo combos; both exist to fill the MXU's lanes and are not
// carried over: here dy is read in its natural layout.
//
// Bound on the H100: bytes at the bf16 tensor-core peak (16 taps x ci x co
// MACs per dx pixel against 4 dy pixels read: 128 operations per byte at
// dec2, 64 at dec1, below the ~295 op/B ridge); this first form runs f32
// FMAs, so in practice operations bind it. Design: a block owns a 16x16
// tile of dx pixels, one per thread, all ci accumulators in registers.
// All 16 taps of the weights sit in shared memory as f32, laid out
// [tap][co][ci] so the inner loop reads them as warp-wide float4
// broadcasts (4 MACs per 16-byte load); the 34x34 dy tile with its halo
// sits beside them as bf16 (odd-word pixel stride). Tensor cores are
// later work.
#include "common.cuh"
#include "ubr_shapes.h"  // UBR_CONV_S2K4_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int QH = 16, QW = 16, NT = QH * QW;
constexpr int YH = 2 * QH + 2, YW = 2 * QW + 2;  // dy rows/cols of a tile

template <int CI, int CO>
struct S2k4Shape {
  static constexpr int CP = CO + 2;            // bf16 per dy pixel (odd words)
  static constexpr int WS = 16 * CO * CI;      // floats
  static constexpr int YS = YH * YW * CP;      // bf16
  static constexpr int SMEM = WS * 4 + YS * 2;
  static_assert(CI % 8 == 0 && CO % 8 == 0, "channel blocking");
};

template <int CI, int CO>
__global__ void __launch_bounds__(NT)
conv_s2k4_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                 bf16* __restrict__ dx, int H, int W) {
  using S = S2k4Shape<CI, CO>;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  bf16* ys = reinterpret_cast<bf16*>(ws + S::WS);

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * QH, j0 = blockIdx.x * QW;
  const int H2 = 2 * H, W2 = 2 * W;

  // weights (tap, ci, co) in global → [tap][co][ci] in shared memory:
  // each thread reads 8 consecutive co of one (tap, ci) as 16 bytes, and
  // neighbouring threads write neighbouring ci
  for (int e = tid; e < 16 * CI * (CO / 8); e += NT) {
    const int ci = e % CI, rest = e / CI;
    const int cq = rest % (CO / 8), tap = rest / (CO / 8);
    const uint4 u = *reinterpret_cast<const uint4*>(
        w + (tap * CI + ci) * CO + cq * 8);
    const bf162* h = reinterpret_cast<const bf162*>(&u);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      ws[(tap * CO + cq * 8 + 2 * q) * CI + ci] = f.x;
      ws[(tap * CO + cq * 8 + 2 * q + 1) * CI + ci] = f.y;
    }
  }
  // dy rows 2*i0-1 .. 2*i0+2*QH, columns 2*j0-1 .. 2*j0+2*QW, zero outside
  for (int e = tid; e < YH * YW * (CO / 2); e += NT) {
    const int c = 2 * (e % (CO / 2)), pix = e / (CO / 2);
    const int r = 2 * i0 - 1 + pix / YW, col = 2 * j0 - 1 + pix % YW;
    bf162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (r >= 0 && r < H2 && col >= 0 && col < W2)
      v = *reinterpret_cast<const bf162*>(
          dy + (((long)n * H2 + r) * W2 + col) * CO + c);
    *reinterpret_cast<bf162*>(ys + pix * S::CP + c) = v;
  }
  __syncthreads();

  const int ty = tid / QW, tx = tid % QW;
  const int i = i0 + ty, j = j0 + tx;
  if (i >= H || j >= W) return;
  float acc[CI];
#pragma unroll
  for (int c = 0; c < CI; ++c) acc[c] = 0.f;
#pragma unroll 1
  for (int tap = 0; tap < 16; ++tap) {
    // dx pixel (ty, tx) reads dy at tile-local (2ty + kr, 2tx + kc)
    const bf16* yp = ys + ((2 * ty + tap / 4) * YW + 2 * tx + tap % 4) * S::CP;
    const float* wp = ws + tap * CO * CI;
#pragma unroll 2
    for (int co = 0; co < CO; co += 2) {
      const float2 yv = ld_bf16x2(yp + co);
      const float4* r0 = reinterpret_cast<const float4*>(wp + co * CI);
      const float4* r1 = reinterpret_cast<const float4*>(wp + (co + 1) * CI);
#pragma unroll
      for (int q = 0; q < CI / 4; ++q) {
        const float4 u = r0[q], v = r1[q];
        acc[4 * q + 0] = fmaf(yv.y, v.x, fmaf(yv.x, u.x, acc[4 * q + 0]));
        acc[4 * q + 1] = fmaf(yv.y, v.y, fmaf(yv.x, u.y, acc[4 * q + 1]));
        acc[4 * q + 2] = fmaf(yv.y, v.z, fmaf(yv.x, u.z, acc[4 * q + 2]));
        acc[4 * q + 3] = fmaf(yv.y, v.w, fmaf(yv.x, u.w, acc[4 * q + 3]));
      }
    }
  }
  store_px<CI>(dx + (((long)n * H + i) * W + j) * CI, acc);
}

template <int CI, int CO>
int launch(const void* dy, const void* w, void* dx, int B, int H, int W,
           cudaStream_t stream) {
  using S = S2k4Shape<CI, CO>;
  static bool smem_set = false;
  cudaError_t e = allow_smem(conv_s2k4_kernel<CI, CO>, S::SMEM, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + QW - 1) / QW, (H + QH - 1) / QH, B);
  conv_s2k4_kernel<CI, CO><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<bf16*>(dx), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co) of the deconv instantiated: UBR_CONV_S2K4_SHAPES, from the one
// table in ops/_build.py:SHAPES. H, W are dx's (the deconv's input side).
UBR_EXPORT int ubr_conv_s2k4(const void* dy, const void* w, void* dx, int B,
                             int H, int W, int ci, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_S2K4(CI, CO) \
  if (ci == CI && co == CO) return launch<CI, CO>(dy, w, dx, B, H, W, s);
  UBR_CONV_S2K4_SHAPES(UBR_S2K4)
#undef UBR_S2K4
  return (int)cudaErrorInvalidValue;
}
