// K3 deconv2x — torch ConvTranspose2d(k=4, stride=2, padding=1,
// bias=False) at exactly 2x, NHWC bf16 in and out, f32 accumulation:
//   out[o] += w[k] * x[i]  where  o = 2i + k - 1  (per spatial axis).
// Each output pixel therefore reads a 2x2 set of input taps fixed by its
// row and column parity: even o uses k = 1 (i = o/2) and k = 3
// (i = o/2 - 1); odd o uses k = 2 (i = (o-1)/2) and k = 0 (i = (o+1)/2).
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:fused_packed_deconv2x
// (_deconv_kernel): the dec2 (128^2 x 64 -> 256^2 x 32) and dec1
// (256^2 x 32 -> 512^2 x 16) upsamples of the flagship UResNet. Weights
// arrive as (kh, kw, ci, co) — the reference checkpoint's IOHW layout
// permuted (2, 3, 0, 1), no spatial flip.
//
// Bound on the H100: bytes at the bf16 tensor-core peak (4 taps x CI x
// CO MACs per output pixel is 170 operations per byte moved at dec2
// and 85 at dec1, below the ~295 op/B ridge), but this first form runs
// f32 FMAs, so in practice operations bind it. The design keeps both
// the input and the weights on chip: a block owns one parity class (a, b)
// of a 32x32 output window — 16x16 pixels, one per thread — so it
// needs only that class's 4 taps of the weights (f32 in shared memory,
// read as warp-wide broadcasts) and an 18x18 input tile (bf16, odd-word
// pixel stride). Tensor cores are the next step, not this one.
#include "common.cuh"
#include "ubr_shapes.h"  // UBR_DECONV2X_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int QH = 16, QW = 16, NT = QH * QW;
constexpr int XH = QH + 2, XW = QW + 2;

__device__ __forceinline__ int tap_k(int parity, int s) {
  return parity == 0 ? (s == 0 ? 1 : 3) : (s == 0 ? 2 : 0);
}
__device__ __forceinline__ int tap_di(int parity, int s) {
  return s == 0 ? 0 : (parity == 0 ? -1 : 1);
}

template <int CI, int CO>
struct DeconvShape {
  static constexpr int CIP = CI + 2;
  static constexpr int WS = 4 * CI * CO;  // floats
  static constexpr int XS = XH * XW * CIP;  // bf16
  static constexpr int SMEM = WS * 4 + XS * 2;
};

template <int CI, int CO>
__global__ void __launch_bounds__(NT)
deconv2x_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ out, int H, int W) {
  using S = DeconvShape<CI, CO>;
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  bf16* xs = reinterpret_cast<bf16*>(ws + S::WS);

  const int tid = threadIdx.x;
  const int n = blockIdx.z / 4, pa = (blockIdx.z / 2) % 2, pb = blockIdx.z % 2;
  const int qy0 = blockIdx.y * QH, qx0 = blockIdx.x * QW;
  const int Ho = 2 * H, Wo = 2 * W;

  // this parity class's 4 taps: t = 2 * s_row + s_col
  for (int e = tid; e < S::WS; e += NT) {
    const int t = e / (CI * CO), rest = e % (CI * CO);
    const int kh = tap_k(pa, t / 2), kw = tap_k(pb, t % 2);
    ws[e] = __bfloat162float(w[(kh * 4 + kw) * CI * CO + rest]);
  }
  // input rows qy0-1 .. qy0+QH, columns qx0-1 .. qx0+QW, zero outside
  for (int e = tid; e < XH * XW * (CI / 2); e += NT) {
    const int c = 2 * (e % (CI / 2)), pix = e / (CI / 2);
    const int ih = qy0 - 1 + pix / XW, iw = qx0 - 1 + pix % XW;
    bf162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = *reinterpret_cast<const bf162*>(
          x + (((long)n * H + ih) * W + iw) * CI + c);
    *reinterpret_cast<bf162*>(xs + pix * S::CIP + c) = v;
  }
  __syncthreads();

  const int ty = tid / QW, tx = tid % QW;
  const int oh = 2 * (qy0 + ty) + pa, ow = 2 * (qx0 + tx) + pb;
  if (oh >= Ho || ow >= Wo) return;
  float acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0.f;
#pragma unroll 1
  for (int t = 0; t < 4; ++t) {
    const int row = ty + 1 + tap_di(pa, t / 2);
    const int col = tx + 1 + tap_di(pb, t % 2);
    const bf16* xp = xs + (row * XW + col) * S::CIP;
    const float* wp = ws + t * CI * CO;
#pragma unroll 4
    for (int ci = 0; ci < CI; ci += 2) {
      const float2 xv = ld_bf16x2(xp + ci);
      const float4* r0 = reinterpret_cast<const float4*>(wp + ci * CO);
      const float4* r1 = reinterpret_cast<const float4*>(wp + (ci + 1) * CO);
#pragma unroll
      for (int q = 0; q < CO / 4; ++q) {
        const float4 u = r0[q], v = r1[q];
        acc[4 * q + 0] = fmaf(xv.y, v.x, fmaf(xv.x, u.x, acc[4 * q + 0]));
        acc[4 * q + 1] = fmaf(xv.y, v.y, fmaf(xv.x, u.y, acc[4 * q + 1]));
        acc[4 * q + 2] = fmaf(xv.y, v.z, fmaf(xv.x, u.z, acc[4 * q + 2]));
        acc[4 * q + 3] = fmaf(xv.y, v.w, fmaf(xv.x, u.w, acc[4 * q + 3]));
      }
    }
  }
  bf16* op = out + (((long)n * Ho + oh) * Wo + ow) * CO;
#pragma unroll
  for (int c = 0; c < CO; c += 2)
    *reinterpret_cast<bf162*>(op + c) =
        __floats2bfloat162_rn(acc[c], acc[c + 1]);
}

template <int CI, int CO>
int launch(const void* x, const void* w, void* out, int B, int H, int W,
           cudaStream_t stream) {
  using S = DeconvShape<CI, CO>;
  static bool smem_set = false;
  cudaError_t e = allow_smem(deconv2x_kernel<CI, CO>, S::SMEM, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + QW - 1) / QW, (H + QH - 1) / QH, 4 * B);
  deconv2x_kernel<CI, CO><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co) instantiated: UBR_DECONV2X_SHAPES, from the one table in
// ops/_build.py:SHAPES.
UBR_EXPORT int ubr_deconv2x(const void* x, const void* w, void* out, int B,
                            int H, int W, int ci, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_DECONV(CI, CO) \
  if (ci == CI && co == CO) return launch<CI, CO>(x, w, out, B, H, W, s);
  UBR_DECONV2X_SHAPES(UBR_DECONV)
#undef UBR_DECONV
  return (int)cudaErrorInvalidValue;
}
