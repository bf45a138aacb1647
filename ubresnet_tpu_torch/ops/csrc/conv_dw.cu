// K6 conv_dw — weight gradient of the stride-1, odd k x k 'same'
// convolution:
//   dw[kh, kw, ci, co] = sum over b, h, w of
//                        x[b, h + kh - r, w + kw - r, ci] * dy[b, h, w, co]
// with zero padding, bf16 x and dy in, f32 accumulation, f32 out in the
// (k, k, ci, co) layout.
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:pallas_conv_dw (_dw_kernel,
// halo_weights_adjoint), which accumulates dW in VMEM across its
// sequential grid. Here each block walks a fixed, strided set of 16x16
// pixel tiles and keeps its share of dW in registers; the block's sum
// goes to its own row of a scratch tensor and sum_rows (partials.cuh)
// adds the rows in order, so dW is the same bits on every run.
//
// Bound on the H100: operations (k*k*ci*co MACs per pixel against
// 2*(ci + co) bytes read: 9*32*32 MACs per 128 bytes at (32,32,3)).
// Design (first, simple form): the x tile with its halo and the dy tile
// sit in shared memory as f32; dW is cut into items of one tap x 4 input
// x COB output channels, each thread owns NI items (4*COB*NI f32
// accumulators) and, when there are fewer items than threads, the
// threads split the tile's pixels into G groups whose sums meet in
// shared memory at the end, in group order. f32 FMA; tensor cores are
// later work.
#include "common.cuh"
#include "partials.cuh"
#include "ubr_shapes.h"  // UBR_CONV_DW_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 16, TW = 16, NT = TH * TW;

template <int CI, int CO, int K>
struct DwShape {
  static constexpr int R = K / 2;
  static constexpr int XH = TH + K - 1, XW = TW + K - 1;
  static constexpr int CIB = 4;
  static constexpr int COB = CO % 8 == 0 ? 8 : CO;
  static constexpr int NCI = CI / CIB, NCO = CO / COB;
  static constexpr int ITEMS = K * K * NCI * NCO;
  static constexpr int G = ITEMS >= NT ? 1 : NT / ITEMS;  // pixel groups
  static constexpr int NI = (ITEMS + NT - 1) / NT;        // items a thread
  static constexpr int CIP = CI + 4;                      // x pixel stride
  static constexpr int DYP = (CO + 3) / 4 * 4;            // dy pixel stride
  static constexpr int XS = XH * XW * CIP;                // floats
  static constexpr int DS = NT * DYP;                     // floats
  static constexpr int ACC = CIB * COB;                   // per item
  static constexpr int RED = G > 1 ? G * ITEMS * ACC : 0; // group sums
  static constexpr int SMEM = (XS + DS > RED ? XS + DS : RED) * 4;
  static constexpr int T = K * K * CI * CO;               // dW elements
  static_assert(CI % CIB == 0 && CO % COB == 0, "channel blocking");
};

template <int CI, int CO, int K>
__global__ void __launch_bounds__(NT)
conv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               float* __restrict__ part, int B, int H, int W) {
  using S = DwShape<CI, CO, K>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ds = xs + S::XS;

  const int tid = threadIdx.x;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TH - 1) / TH;
  const int ntiles = B * tiles_h * tiles_w;
  // this thread's pixel group and items
  const int group = S::G > 1 ? tid / S::ITEMS : 0;
  const bool active = group < S::G;
  int item[S::NI];
#pragma unroll
  for (int j = 0; j < S::NI; ++j)
    item[j] = S::G > 1 ? tid % S::ITEMS : tid + j * NT;

  float acc[S::NI][S::ACC];
#pragma unroll
  for (int j = 0; j < S::NI; ++j)
#pragma unroll
    for (int a = 0; a < S::ACC; ++a) acc[j][a] = 0.f;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int b = t / (tiles_h * tiles_w);
    const int rem = t % (tiles_h * tiles_w);
    const int oh0 = (rem / tiles_w) * TH, ow0 = (rem % tiles_w) * TW;
    __syncthreads();  // the previous tile's reads are done
    for (int e = tid; e < S::XH * S::XW * CI; e += NT) {
      const int c = e % CI, pix = e / CI;
      const int ih = oh0 - S::R + pix / S::XW;
      const int iw = ow0 - S::R + pix % S::XW;
      float v = 0.f;
      if (ih >= 0 && ih < H && iw >= 0 && iw < W)
        v = __bfloat162float(x[(((long)b * H + ih) * W + iw) * CI + c]);
      xs[pix * S::CIP + c] = v;
    }
    for (int e = tid; e < NT * CO; e += NT) {  // zero outside the image
      const int c = e % CO, pix = e / CO;
      const int oh = oh0 + pix / TW, ow = ow0 + pix % TW;
      float v = 0.f;
      if (oh < H && ow < W)
        v = __bfloat162float(dy[(((long)b * H + oh) * W + ow) * CO + c]);
      ds[pix * S::DYP + c] = v;
    }
    __syncthreads();
    if (!active) continue;

#pragma unroll
    for (int j = 0; j < S::NI; ++j) {
      if (item[j] >= S::ITEMS) continue;
      const int cob = item[j] % S::NCO, rest = item[j] / S::NCO;
      const int cib = rest % S::NCI, tap = rest / S::NCI;
      const int kh = tap / K, kw = tap % K;
      const float* xb = xs + (kh * S::XW + kw) * S::CIP + cib * S::CIB;
      const float* db = ds + cob * S::COB;
#pragma unroll 2
      for (int p = group; p < NT; p += S::G) {
        const int py = p / TW, px = p % TW;
        const float4 xv =
            *reinterpret_cast<const float4*>(xb + (py * S::XW + px) * S::CIP);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float* dp = db + p * S::DYP;
        float dv[S::COB];
#pragma unroll
        for (int o = 0; o < S::COB; ++o) dv[o] = dp[o];
#pragma unroll
        for (int i = 0; i < S::CIB; ++i)
#pragma unroll
          for (int o = 0; o < S::COB; ++o)
            acc[j][i * S::COB + o] = fmaf(xa[i], dv[o], acc[j][i * S::COB + o]);
      }
    }
  }

  // this block's dW: straight from registers, or the pixel groups'
  // sums added in group order through shared memory
  float* row = part + (long)blockIdx.x * S::T;
  auto store = [&](int it, const float* v) {
    const int cob = it % S::NCO, rest = it / S::NCO;
    const int cib = rest % S::NCI, tap = rest / S::NCI;
#pragma unroll
    for (int i = 0; i < S::CIB; ++i)
#pragma unroll
      for (int o = 0; o < S::COB; ++o)
        row[(tap * CI + cib * S::CIB + i) * CO + cob * S::COB + o] =
            v[i * S::COB + o];
  };
  if (S::G == 1) {
#pragma unroll
    for (int j = 0; j < S::NI; ++j)
      if (item[j] < S::ITEMS) store(item[j], acc[j]);
    return;
  }
  __syncthreads();  // tiles done: reuse shared memory for group sums
  float* red = xs;
  if (active)
#pragma unroll
    for (int a = 0; a < S::ACC; ++a)
      red[(group * S::ITEMS + item[0]) * S::ACC + a] = acc[0][a];
  __syncthreads();
  if (tid < S::ITEMS) {
    float v[S::ACC];
#pragma unroll
    for (int a = 0; a < S::ACC; ++a) {
      float s = 0.f;
      for (int g = 0; g < S::G; ++g) s += red[(g * S::ITEMS + tid) * S::ACC + a];
      v[a] = s;
    }
    store(tid, v);
  }
}

template <int CI, int CO, int K>
int launch(const void* x, const void* dy, void* part, void* dw, int B, int H,
           int W, int blocks, cudaStream_t stream) {
  using S = DwShape<CI, CO, K>;
  static bool smem_set = false;
  cudaError_t e = allow_smem(conv_dw_kernel<CI, CO, K>, S::SMEM, &smem_set);
  if (e != cudaSuccess) return (int)e;
  conv_dw_kernel<CI, CO, K><<<blocks, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<float*>(part), B, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(static_cast<const float*>(part), blocks, S::T, 1.f,
                       static_cast<float*>(dw), stream);
}

}  // namespace

// (ci, co, k) instantiated: UBR_CONV_DW_SHAPES, from the one table in
// ops/_build.py:SHAPES. part is the wrapper's (blocks, k*k*ci*co) f32
// scratch; dw is (k, k, ci, co) f32.
UBR_EXPORT int ubr_conv_dw(const void* x, const void* dy, void* part,
                           void* dw, int B, int H, int W, int ci, int co,
                           int k, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
#define UBR_DW(CI, CO, K)                                                  \
  if (ci == CI && co == CO && k == K)                                      \
    return launch<CI, CO, K>(x, dy, part, dw, B, H, W, blocks, s);
  UBR_CONV_DW_SHAPES(UBR_DW)
#undef UBR_DW
  return (int)cudaErrorInvalidValue;
}
