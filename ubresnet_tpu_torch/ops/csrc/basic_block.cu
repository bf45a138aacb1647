// K2 basic_block — a whole stride-1 eval BasicBlock in one launch,
//   out = relu( relu(bn2(conv2(m))) + bypass(x) ),
//   m   = bf16( relu(bn1(conv1(x))) ),
// conv1/conv2 3x3 'same', bypass a 1x1 conv + BN or the identity, with
// an optional second input stream: x is then the channel concat [a, b]
// (the decoder skip join, up-sampled stream first) and the concat never
// exists outside shared memory.
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:fused_basic_block
// (_block_kernel) and fused_dual_block (_dual_block_kernel): enc1.res1
// and .res2, and dec2/dec1 res.res1 (dual) and res.res2 of the flagship
// UResNet. As on the TPU, the intermediate m of the output tile plus a
// one-pixel halo is recomputed per tile and stays on chip, so the block
// moves one read of x and one write of out instead of six tensor
// round trips. m is rounded to bf16 before conv2, as the unfused path
// rounds it; outside the image m is zero (conv2's own 'same' padding),
// not relu(bn1(conv1(padding))).
//
// Bound on the H100: operations (two 3x3 convs of 32 channels per 128
// bytes moved). Design (first, simple form): one block computes an
// 8x16 output tile with 256 threads; the input tile with a two-pixel
// halo and m are bf16 in shared memory with an odd-word pixel stride
// (conflict-free per-thread reads), the weights are f32 in shared
// memory read as warp-wide 16-byte broadcasts, and each thread
// accumulates 16 output channels of one pixel in registers with f32
// FMAs. Tensor cores are the next step, not this one.
#include "common.cuh"
#include "ubr_shapes.h"  // UBR_BASIC_BLOCK_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 8, TW = 16, NT = 256, G = 16;  // G: channels a thread
constexpr int XH = TH + 4, XW = TW + 4;           // input tile, 2-px halo
constexpr int MH = TH + 2, MW = TW + 2;           // intermediate, 1-px halo

template <int CA, int CB, int CO, bool PROJ>
struct BlockShape {
  static constexpr int CIN = CA + CB;
  static constexpr int CINP = CIN + 2;  // bf16 pixel strides: odd words
  static constexpr int COP = CO + 2;
  static constexpr int W1 = 9 * CIN * CO, W2 = 9 * CO * CO;
  static constexpr int WB = PROJ ? CIN * CO : 0;
  static constexpr int PRM = 6 * CO;  // g1 b1 g2 b2 gb bb
  static constexpr int F32 = W1 + W2 + WB + PRM;
  static constexpr int XS = XH * XW * CINP, MS = MH * MW * COP;
  static constexpr int SMEM = F32 * 4 + (XS + MS) * 2;
};

template <int CA, int CB, int CO, bool PROJ>
__global__ void __launch_bounds__(NT)
basic_block_kernel(const bf16* __restrict__ a, const bf16* __restrict__ bsrc,
                   const bf16* __restrict__ w1, const float* __restrict__ g1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ g2, const float* __restrict__ b2,
                   const bf16* __restrict__ wb, const float* __restrict__ gb,
                   const float* __restrict__ bb, bf16* __restrict__ out,
                   int H, int W) {
  using S = BlockShape<CA, CB, CO, PROJ>;
  constexpr int CIN = S::CIN, NG = CO / G;
  extern __shared__ float4 smem4[];
  float* w1s = reinterpret_cast<float*>(smem4);
  float* w2s = w1s + S::W1;
  float* wbs = w2s + S::W2;
  float* prm = wbs + S::WB;
  bf16* xs = reinterpret_cast<bf16*>(prm + S::PRM);
  bf16* ms = xs + S::XS;

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * TH, ow0 = blockIdx.x * TW;

  for (int e = tid; e < S::W1; e += NT) w1s[e] = __bfloat162float(w1[e]);
  for (int e = tid; e < S::W2; e += NT) w2s[e] = __bfloat162float(w2[e]);
  if (PROJ)
    for (int e = tid; e < S::WB; e += NT) wbs[e] = __bfloat162float(wb[e]);
  for (int e = tid; e < CO; e += NT) {
    prm[e] = g1[e];
    prm[CO + e] = b1[e];
    prm[2 * CO + e] = g2[e];
    prm[3 * CO + e] = b2[e];
    prm[4 * CO + e] = PROJ ? gb[e] : 0.f;
    prm[5 * CO + e] = PROJ ? bb[e] : 0.f;
  }
  // input tile [a | b] with a two-pixel halo, zero outside the image
  for (int e = tid; e < XH * XW * (CIN / 2); e += NT) {
    const int c = 2 * (e % (CIN / 2)), pix = e / (CIN / 2);
    const int ih = oh0 - 2 + pix / XW, iw = ow0 - 2 + pix % XW;
    bf162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
      const long p = ((long)n * H + ih) * W + iw;
      v = c < CA ? *reinterpret_cast<const bf162*>(a + p * CA + c)
                 : *reinterpret_cast<const bf162*>(bsrc + p * CB + c - CA);
    }
    *reinterpret_cast<bf162*>(xs + pix * S::CINP + c) = v;
  }
  __syncthreads();

  // conv1 + BN1 + ReLU over the tile and its one-pixel halo -> ms (bf16)
  for (int it = tid; it < NG * MH * MW; it += NT) {
    const int grp = it / (MH * MW), pos = it % (MH * MW);
    const int my = pos / MW, mx = pos % MW;
    const int ih = oh0 - 1 + my, iw = ow0 - 1 + mx;
    bf16* mp = ms + pos * S::COP + grp * G;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) {
#pragma unroll
      for (int j = 0; j < G; j += 2)
        *reinterpret_cast<bf162*>(mp + j) = __floats2bfloat162_rn(0.f, 0.f);
      continue;
    }
    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const bf16* xp = xs + ((my + t / 3) * XW + mx + t % 3) * S::CINP;
      const float* wp = w1s + t * CIN * CO + grp * G;
#pragma unroll 8
      for (int ci = 0; ci < CIN; ci += 2) {
        const float2 xv = ld_bf16x2(xp + ci);
        const float4* r0 = reinterpret_cast<const float4*>(wp + ci * CO);
        const float4* r1 = reinterpret_cast<const float4*>(wp + (ci + 1) * CO);
#pragma unroll
        for (int q = 0; q < G / 4; ++q) {
          const float4 u = r0[q], v = r1[q];
          acc[4 * q + 0] = fmaf(xv.y, v.x, fmaf(xv.x, u.x, acc[4 * q + 0]));
          acc[4 * q + 1] = fmaf(xv.y, v.y, fmaf(xv.x, u.y, acc[4 * q + 1]));
          acc[4 * q + 2] = fmaf(xv.y, v.z, fmaf(xv.x, u.z, acc[4 * q + 2]));
          acc[4 * q + 3] = fmaf(xv.y, v.w, fmaf(xv.x, u.w, acc[4 * q + 3]));
        }
      }
    }
    const float* gg = prm + grp * G;
    const float* bbias = prm + CO + grp * G;
#pragma unroll
    for (int j = 0; j < G; j += 2) {
      const float y0 = fmaxf(acc[j] * gg[j] + bbias[j], 0.f);
      const float y1 = fmaxf(acc[j + 1] * gg[j + 1] + bbias[j + 1], 0.f);
      *reinterpret_cast<bf162*>(mp + j) = __floats2bfloat162_rn(y0, y1);
    }
  }
  __syncthreads();

  // conv2 + BN2 + pre-add ReLU, bypass, add, ReLU -> out
  for (int it = tid; it < NG * TH * TW; it += NT) {
    const int grp = it / (TH * TW), pos = it % (TH * TW);
    const int py = pos / TW, px = pos % TW;
    const int oh = oh0 + py, ow = ow0 + px;
    if (oh >= H || ow >= W) continue;
    float acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const bf16* mp = ms + ((py + t / 3) * MW + px + t % 3) * S::COP;
      const float* wp = w2s + t * CO * CO + grp * G;
#pragma unroll 8
      for (int ci = 0; ci < CO; ci += 2) {
        const float2 xv = ld_bf16x2(mp + ci);
        const float4* r0 = reinterpret_cast<const float4*>(wp + ci * CO);
        const float4* r1 = reinterpret_cast<const float4*>(wp + (ci + 1) * CO);
#pragma unroll
        for (int q = 0; q < G / 4; ++q) {
          const float4 u = r0[q], v = r1[q];
          acc[4 * q + 0] = fmaf(xv.y, v.x, fmaf(xv.x, u.x, acc[4 * q + 0]));
          acc[4 * q + 1] = fmaf(xv.y, v.y, fmaf(xv.x, u.y, acc[4 * q + 1]));
          acc[4 * q + 2] = fmaf(xv.y, v.z, fmaf(xv.x, u.z, acc[4 * q + 2]));
          acc[4 * q + 3] = fmaf(xv.y, v.w, fmaf(xv.x, u.w, acc[4 * q + 3]));
        }
      }
    }
    const bf16* xc = xs + ((py + 2) * XW + px + 2) * S::CINP;  // centre
    float r[G];
    if (PROJ) {
#pragma unroll
      for (int j = 0; j < G; ++j) r[j] = 0.f;
      const float* wp = wbs + grp * G;
#pragma unroll 8
      for (int ci = 0; ci < CIN; ci += 2) {
        const float2 xv = ld_bf16x2(xc + ci);
        const float4* r0 = reinterpret_cast<const float4*>(wp + ci * CO);
        const float4* r1 = reinterpret_cast<const float4*>(wp + (ci + 1) * CO);
#pragma unroll
        for (int q = 0; q < G / 4; ++q) {
          const float4 u = r0[q], v = r1[q];
          r[4 * q + 0] = fmaf(xv.y, v.x, fmaf(xv.x, u.x, r[4 * q + 0]));
          r[4 * q + 1] = fmaf(xv.y, v.y, fmaf(xv.x, u.y, r[4 * q + 1]));
          r[4 * q + 2] = fmaf(xv.y, v.z, fmaf(xv.x, u.z, r[4 * q + 2]));
          r[4 * q + 3] = fmaf(xv.y, v.w, fmaf(xv.x, u.w, r[4 * q + 3]));
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j)
        r[j] = r[j] * prm[4 * CO + grp * G + j] + prm[5 * CO + grp * G + j];
    } else {
#pragma unroll
      for (int j = 0; j < G; j += 2) {
        const float2 xv = ld_bf16x2(xc + grp * G + j);
        r[j] = xv.x;
        r[j + 1] = xv.y;
      }
    }
    const float* gg = prm + 2 * CO + grp * G;
    const float* bbias = prm + 3 * CO + grp * G;
    bf16* op = out + (((long)n * H + oh) * W + ow) * CO + grp * G;
#pragma unroll
    for (int j = 0; j < G; j += 2) {
      const float y0 = fmaxf(fmaxf(acc[j] * gg[j] + bbias[j], 0.f) + r[j], 0.f);
      const float y1 = fmaxf(
          fmaxf(acc[j + 1] * gg[j + 1] + bbias[j + 1], 0.f) + r[j + 1], 0.f);
      *reinterpret_cast<bf162*>(op + j) = __floats2bfloat162_rn(y0, y1);
    }
  }
}

template <int CA, int CB, int CO, bool PROJ>
int launch(const void* a, const void* b, const void* w1, const void* g1,
           const void* b1, const void* w2, const void* g2, const void* b2,
           const void* wb, const void* gb, const void* bb, void* out, int B,
           int H, int W, cudaStream_t stream) {
  using S = BlockShape<CA, CB, CO, PROJ>;
  static bool smem_set = false;
  cudaError_t e =
      allow_smem(basic_block_kernel<CA, CB, CO, PROJ>, S::SMEM, &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  basic_block_kernel<CA, CB, CO, PROJ><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(w1), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(g2), static_cast<const float*>(b2),
      static_cast<const bf16*>(wb), static_cast<const float*>(gb),
      static_cast<const float*>(bb), static_cast<bf16*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// (ca, cb, co, projection) instantiated: UBR_BASIC_BLOCK_SHAPES, from
// the one table in ops/_build.py:SHAPES. cb = 0 is the single-stream
// block; wb == NULL selects the identity bypass.
UBR_EXPORT int ubr_basic_block(const void* a, const void* b, const void* w1,
                               const void* g1, const void* b1, const void* w2,
                               const void* g2, const void* b2, const void* wb,
                               const void* gb, const void* bb, void* out,
                               int B, int H, int W, int ca, int cb, int co,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool proj = wb != nullptr;
#define UBR_BLOCK(CA, CB, CO, P)                                            \
  if (ca == CA && cb == CB && co == CO && proj == P)                        \
    return launch<CA, CB, CO, P>(a, b, w1, g1, b1, w2, g2, b2, wb, gb, bb, \
                                 out, B, H, W, s);
  UBR_BASIC_BLOCK_SHAPES(UBR_BLOCK)
#undef UBR_BLOCK
  return (int)cudaErrorInvalidValue;
}
