// K3-s8 deconv2x_s8 — the int8 mode of K3: torch ConvTranspose2d(k=4,
// stride=2, padding=1, bias=False) at exactly 2x of an NHWC int8 tensor
// with an int8 (kh, kw, ci, co) kernel, exact s32 accumulation, then the
// dequant out = f32(acc) * g[co] (g = sx·sw), stored as bf16 (the model)
// or float (checks). Tap geometry as K3: out[o] += w[k]·x[i] with
// o = 2i + k - 1, so each output pixel reads a 2x2 set of input taps
// fixed by its row and column parity.
//
// Replaces the quantized=True mode of
// ubresnet_tpu/ops/pallas_conv.py:fused_packed_deconv2x
// (_deconv_kernel): the dec2 (128^2 x 64 -> 256^2 x 32) and dec1
// (256^2 x 32 -> 512^2 x 16) upsamples of the flagship UResNet under
// int8 deploy.
//
// Bound on the H100: bytes (4 taps x CI x CO MACs per output pixel
// against CI/4 + 2·CO bytes moved is 205 op/B at dec2 and 102 at dec1,
// under the ~590 op/B int8 ridge). Design (as K3): a block
// owns one parity class of a 32x32 output window — 16x16 pixels, one per
// thread — so it keeps only that class's 4 taps of the weights (packed
// as __dp4a operands, read as warp-wide broadcasts) and an 18x18 int8
// input tile (odd 16-byte pixel stride) in shared memory; each thread
// accumulates CO channels in s32 registers.
#include "common.cuh"
#include "ubr_shapes.h"  // UBR_DECONV2X_S8_SHAPES (ops/_build.py:SHAPES)

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
struct DeconvS8Shape {
  static_assert(CI % 16 == 0 && CO % 8 == 0, "int8 deconv channel grain");
  static constexpr int CG = CI / 4;           // input words per pixel
  static constexpr int XWD = s8_words(CI);    // padded pixel stride
  static constexpr int WS = 4 * CG * CO;      // weight words (4 taps)
  static constexpr int XS = XH * XW * XWD;    // input words
  static constexpr int SMEM = (WS + XS) * 4;
};

template <int CI, int CO, typename OT>
__global__ void __launch_bounds__(NT)
deconv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ g, OT* __restrict__ out, int H,
                 int W) {
  using S = DeconvS8Shape<CI, CO>;
  extern __shared__ int4 smem_s8[];
  int* ws = reinterpret_cast<int*>(smem_s8);
  int* xs = ws + S::WS;

  const int tid = threadIdx.x;
  const int n = blockIdx.z / 4, pa = (blockIdx.z / 2) % 2, pb = blockIdx.z % 2;
  const int qy0 = blockIdx.y * QH, qx0 = blockIdx.x * QW;
  const int Ho = 2 * H, Wo = 2 * W;

  // this parity class's 4 taps (t = 2 * s_row + s_col) -> words
  // [t][ci / 4][co]
  for (int e = tid; e < S::WS; e += NT) {
    const int co = e % CO, row = e / CO;
    const int cg = row % S::CG, t = row / S::CG;
    const int kh = tap_k(pa, t / 2), kw = tap_k(pb, t % 2);
    ws[e] = pack_s8x4(w + ((long)(kh * 4 + kw) * CI + 4 * cg) * CO + co, CO);
  }
  // input rows qy0-1 .. qy0+QH, columns qx0-1 .. qx0+QW, zero outside
  for (int e = tid; e < XH * XW * S::CG; e += NT) {
    const int cg = e % S::CG, pix = e / S::CG;
    const int ih = qy0 - 1 + pix / XW, iw = qx0 - 1 + pix % XW;
    int v = 0;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W)
      v = *reinterpret_cast<const int*>(
          x + (((long)n * H + ih) * W + iw) * CI + 4 * cg);
    xs[pix * S::XWD + cg] = v;
  }
  __syncthreads();

  const int ty = tid / QW, tx = tid % QW;
  const int oh = 2 * (qy0 + ty) + pa, ow = 2 * (qx0 + tx) + pb;
  if (oh >= Ho || ow >= Wo) return;
  int acc[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c) acc[c] = 0;
#pragma unroll 1
  for (int t = 0; t < 4; ++t) {
    const int row = ty + 1 + tap_di(pa, t / 2);
    const int col = tx + 1 + tap_di(pb, t % 2);
    const int* xp = xs + (row * XW + col) * S::XWD;
    const int* wp = ws + t * S::CG * CO;
#pragma unroll 2
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
  float y[CO];
#pragma unroll
  for (int c = 0; c < CO; ++c)
    y[c] = __fmul_rn(__int2float_rn(acc[c]), __ldg(g + c));
  store_px<CO>(out + (((long)n * Ho + oh) * Wo + ow) * CO, y);
}

template <int CI, int CO, typename OT>
int launch(const void* x, const void* w, const void* g, void* out, int B,
           int H, int W, cudaStream_t stream) {
  using S = DeconvS8Shape<CI, CO>;
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(deconv_s8_kernel<CI, CO, OT>, S::SMEM, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + QW - 1) / QW, (H + QH - 1) / QH, 4 * B);
  deconv_s8_kernel<CI, CO, OT><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(g), static_cast<OT*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co) instantiated: UBR_DECONV2X_S8_SHAPES, from the one table in
// ops/_build.py:SHAPES; out_f32 selects a float output instead of bf16.
UBR_EXPORT int ubr_deconv2x_s8(const void* x, const void* w, const void* g,
                               void* out, int B, int H, int W, int ci, int co,
                               int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_DECONV_S8(CI, CO)                                             \
  if (ci == CI && co == CO)                                               \
    return out_f32 ? launch<CI, CO, float>(x, w, g, out, B, H, W, s)      \
                   : launch<CI, CO, bf16>(x, w, g, out, B, H, W, s);
  UBR_DECONV2X_S8_SHAPES(UBR_DECONV_S8)
#undef UBR_DECONV_S8
  return (int)cudaErrorInvalidValue;
}
