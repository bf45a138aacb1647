// K9 deconv_dw — weight gradient of ConvTranspose2d(k=4, stride=2,
// padding=1):
//   dW[kr, kc, ci, co] = sum over b, i, j of
//                        x[b, i, j, ci] * dy[b, 2i + kr - 1, 2j + kc - 1, co]
// with zeros outside dy, bf16 x (B, H, W, ci) — the deconv's input — and
// dy (B, 2H, 2W, co) — its output cotangent —, f32 accumulation, f32 dW in
// the deconv's (4, 4, ci, co) layout.
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:pallas_deconv_dw
// (_deconv_dw_kernel, deconv_dw_adjoint), which accumulates dW in VMEM
// across its sequential grid over 2p-packed parity planes. Here, as in K6
// (conv_dw.cu), each block walks a fixed, strided set of 8x16 x-pixel
// tiles and keeps its share of dW in registers; the block's sum goes to
// its own row of a scratch tensor and sum_rows (partials.cuh) adds the
// rows in order, so dW is the same bits on every run. No atomics.
//
// Bound on the H100: bytes at the bf16 tensor-core peak (16 x ci x co
// MACs per x pixel against one x and four dy pixels read); this first
// form runs f32 FMAs, so operations bind it in practice. Design: the x
// tile and its 18x34 dy tile sit in shared memory as f32; a thread owns
// one item — one tap and 4 input channels — with all co outputs, 4*co
// f32 accumulators, and per pixel reads one float4 of x and co/4 float4s
// of dy for 4*co FMAs. Where there are fewer items than threads (ci = 32)
// the threads split the tile's pixels into G groups whose sums meet in
// shared memory at the end, in group order. Tensor cores are later work.
#include "common.cuh"
#include "partials.cuh"
#include "ubr_shapes.h"  // UBR_DECONV_DW_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 8, TW = 16, NP = TH * TW, NT = 256;
constexpr int YH = 2 * TH + 2, YW = 2 * TW + 2;  // dy rows/cols of a tile

template <int CI, int CO>
struct DdwShape {
  static constexpr int NCI = CI / 4;
  static constexpr int ITEMS = 16 * NCI;             // (tap, 4 ci)
  static constexpr int G = NT / ITEMS;               // pixel groups
  static constexpr int ACC = 4 * CO;                 // per item
  static constexpr int CIP = CI + 4;                 // x pixel stride
  static constexpr int DYP = CO + 4;                 // dy pixel stride
  static constexpr int XS = NP * CIP;                // floats
  static constexpr int DS = YH * YW * DYP;           // floats
  static constexpr int RED = G > 1 ? G * ITEMS * ACC : 0;
  static constexpr int SMEM = (XS + DS > RED ? XS + DS : RED) * 4;
  static constexpr int T = 16 * CI * CO;             // dW elements
  static_assert(CI % 4 == 0 && CO % 4 == 0, "channel blocking");
  static_assert(ITEMS <= NT && NT % ITEMS == 0, "items per block");
};

template <int CI, int CO>
__global__ void __launch_bounds__(NT)
deconv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 float* __restrict__ part, int B, int H, int W) {
  using S = DdwShape<CI, CO>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ds = xs + S::XS;

  const int tid = threadIdx.x;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;
  const int H2 = 2 * H, W2 = 2 * W;
  const int group = tid / S::ITEMS, item = tid % S::ITEMS;
  const int tap = item / S::NCI, cib = item % S::NCI;
  const int kr = tap / 4, kc = tap % 4;

  float acc[S::ACC];
#pragma unroll
  for (int a = 0; a < S::ACC; ++a) acc[a] = 0.f;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / (tiles_h * tiles_w);
    const int rem = t % (tiles_h * tiles_w);
    const int i0 = (rem / tiles_w) * TH, j0 = (rem % tiles_w) * TW;
    __syncthreads();  // the previous tile's reads are done
    for (int e = tid; e < NP * (CI / 2); e += NT) {  // zero outside x
      const int c = 2 * (e % (CI / 2)), pix = e / (CI / 2);
      const int i = i0 + pix / TW, j = j0 + pix % TW;
      float2 v = make_float2(0.f, 0.f);
      if (i < H && j < W)
        v = __bfloat1622float2(*reinterpret_cast<const bf162*>(
            x + (((long)b * H + i) * W + j) * CI + c));
      *reinterpret_cast<float2*>(xs + pix * S::CIP + c) = v;
    }
    // dy rows 2*i0-1 .. 2*i0+2*TH, columns 2*j0-1 .. 2*j0+2*TW
    for (int e = tid; e < YH * YW * (CO / 2); e += NT) {
      const int c = 2 * (e % (CO / 2)), pix = e / (CO / 2);
      const int r = 2 * i0 - 1 + pix / YW, col = 2 * j0 - 1 + pix % YW;
      float2 v = make_float2(0.f, 0.f);
      if (r >= 0 && r < H2 && col >= 0 && col < W2)
        v = __bfloat1622float2(*reinterpret_cast<const bf162*>(
            dy + (((long)b * H2 + r) * W2 + col) * CO + c));
      *reinterpret_cast<float2*>(ds + pix * S::DYP + c) = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int p = group; p < NP; p += S::G) {
      const int py = p / TW, px = p % TW;
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + p * S::CIP + cib * 4);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      // x pixel (py, px) meets dy at tile-local (2py + kr, 2px + kc)
      const float4* dp = reinterpret_cast<const float4*>(
          ds + ((2 * py + kr) * YW + 2 * px + kc) * S::DYP);
#pragma unroll
      for (int q = 0; q < CO / 4; ++q) {
        const float4 d = dp[q];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = i * CO + 4 * q;
          acc[a + 0] = fmaf(xa[i], d.x, acc[a + 0]);
          acc[a + 1] = fmaf(xa[i], d.y, acc[a + 1]);
          acc[a + 2] = fmaf(xa[i], d.z, acc[a + 2]);
          acc[a + 3] = fmaf(xa[i], d.w, acc[a + 3]);
        }
      }
    }
  }

  // this block's dW: the item's 4 x co block is contiguous in (tap, ci,
  // co) order; straight from registers, or the pixel groups' sums added
  // in group order through shared memory
  float* row = part + (long)blockIdx.x * S::T + (tap * CI + cib * 4) * CO;
  if (S::G == 1) {
#pragma unroll
    for (int a = 0; a < S::ACC; a += 4)
      *reinterpret_cast<float4*>(row + a) =
          make_float4(acc[a], acc[a + 1], acc[a + 2], acc[a + 3]);
    return;
  }
  __syncthreads();  // tiles done: reuse shared memory for group sums
  float* red = xs;
#pragma unroll
  for (int a = 0; a < S::ACC; ++a)
    red[(group * S::ITEMS + item) * S::ACC + a] = acc[a];
  __syncthreads();
  if (group == 0) {
    for (int a = 0; a < S::ACC; ++a) {
      float s = 0.f;
      for (int g = 0; g < S::G; ++g)
        s += red[(g * S::ITEMS + item) * S::ACC + a];
      row[a] = s;
    }
  }
}

template <int CI, int CO>
int launch(const void* x, const void* dy, void* part, void* dw, int B, int H,
           int W, int blocks, cudaStream_t stream) {
  using S = DdwShape<CI, CO>;
  static bool smem_set = false;
  cudaError_t e = allow_smem(deconv_dw_kernel<CI, CO>, S::SMEM, &smem_set);
  if (e != cudaSuccess) return (int)e;
  deconv_dw_kernel<CI, CO><<<blocks, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<float*>(part), B, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(static_cast<const float*>(part), blocks, S::T, 1.f,
                       static_cast<float*>(dw), stream);
}

}  // namespace

// (ci, co) of the deconv instantiated: UBR_DECONV_DW_SHAPES, from the one
// table in ops/_build.py:SHAPES. H, W are x's; part is the wrapper's
// (blocks, 16*ci*co) f32 scratch; dw is (4, 4, ci, co) f32.
UBR_EXPORT int ubr_deconv_dw(const void* x, const void* dy, void* part,
                             void* dw, int B, int H, int W, int ci, int co,
                             int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
#define UBR_DDW(CI, CO)                                                    \
  if (ci == CI && co == CO)                                                \
    return launch<CI, CO>(x, dy, part, dw, B, H, W, blocks, s);
  UBR_DECONV_DW_SHAPES(UBR_DDW)
#undef UBR_DDW
  return (int)cudaErrorInvalidValue;
}
