// K2-s8 basic_block_s8 — the int8 mode of K2: a whole stride-1 eval
// BasicBlock over int8 input, optionally over the implicit channel concat
// of two int8 streams that share one scale,
//   m   = rint(min(relu(f32(conv1(x)) * g1 + b1), 127))     (int8)
//   out = relu( relu(f32(conv2(m)) * g2 + b2) + bypass )
//   bypass = f32(conv1x1(x)) * gb + bb   (projection)
//          | f32(x) * gb + bb            (identity, gb = sx, bb = 0)
// with exact s32 accumulation. The caller folds the dequant chain into
// the affines (ops/quant.py, models/blocks.py): g1/b1 carry
// sx·sw1 / s_mid, so conv1's epilogue lands on conv2's int8 grid
// (requantized on chip, rounded half to even by rintf), g2 carries
// s_mid·sw2, gb sx·swb.
//
// Replaces the quantized=True modes of
// ubresnet_tpu/ops/pallas_conv.py:fused_basic_block (_block_kernel) and
// fused_dual_block (_dual_block_kernel): enc1.res1/.res2 and dec2/dec1
// res.res1 (dual) and res.res2 of the flagship UResNet under int8
// deploy. As in K2, m of the output tile plus a one-pixel halo is
// recomputed per tile and stays in shared memory; outside the image m is
// zero (conv2's own padding).
//
// Bound on the H100: bytes at the int8 tensor-core peak (two 3x3 convs
// of 32 channels per pixel against 32 + 64 bytes moved is ~380 op/B,
// under the ~590 op/B int8 ridge); this first form runs __dp4a on the
// CUDA cores, so operations bind it in practice. Design (as K2): an 8x16
// output tile per block of 256 threads; the int8 input tile with a
// two-pixel halo and the int8 m at odd 16-byte pixel strides, the
// weights packed as __dp4a operands, all in shared memory; each thread
// accumulates 16 output channels of one pixel in s32 registers.
#include "common.cuh"
#include "ubr_shapes.h"  // UBR_BASIC_BLOCK_S8_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 8, TW = 16, NT = 256, G = 16;  // G: channels a thread
constexpr int XH = TH + 4, XW = TW + 4;           // input tile, 2-px halo
constexpr int MH = TH + 2, MW = TW + 2;           // intermediate, 1-px halo

template <int CA, int CB, int CO, bool PROJ>
struct BlockS8Shape {
  static constexpr int CIN = CA + CB;
  static_assert(CIN % 16 == 0 && CO % G == 0 && CA % 4 == 0,
                "int8 block channel grain");
  static constexpr int CGI = CIN / 4, CGO = CO / 4;  // words per pixel
  static constexpr int XWD = s8_words(CIN), MWD = s8_words(CO);
  static constexpr int W1 = 9 * CGI * CO, W2 = 9 * CGO * CO;  // words
  static constexpr int WB = PROJ ? CGI * CO : 0;
  static constexpr int PRM = 6 * CO;  // g1 b1 g2 b2 gb bb (floats)
  static constexpr int XS = XH * XW * XWD, MS = MH * MW * MWD;
  static constexpr int SMEM = (W1 + W2 + WB + PRM + XS + MS) * 4;
};

// words [tap][ci / 4][co] from an int8 (taps, ci, co) kernel
__device__ __forceinline__ void load_s8_weights(int* dst, const int8_t* w,
                                                int taps, int ci, int co,
                                                int tid) {
  const int cg_n = ci / 4, n = taps * cg_n * co;
  for (int e = tid; e < n; e += NT) {
    const int c = e % co, row = e / co;
    const int cg = row % cg_n, tap = row / cg_n;
    dst[e] = pack_s8x4(w + ((long)tap * ci + 4 * cg) * co + c, co);
  }
}

// acc[0..G) += the G output channels of words wp[cg * CO + ...] against
// the NCG input words at xp (both in shared memory)
template <int NCG, int CO>
__device__ __forceinline__ void dot_s8(int* acc, const int* xp,
                                       const int* wp) {
#pragma unroll
  for (int c16 = 0; c16 < NCG; c16 += 4) {
    const int4 xv = *reinterpret_cast<const int4*>(xp + c16);
    const int xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int4* wr = reinterpret_cast<const int4*>(wp + (c16 + j) * CO);
#pragma unroll
      for (int q = 0; q < G / 4; ++q) {
        const int4 wv = wr[q];
        acc[4 * q + 0] = __dp4a(xa[j], wv.x, acc[4 * q + 0]);
        acc[4 * q + 1] = __dp4a(xa[j], wv.y, acc[4 * q + 1]);
        acc[4 * q + 2] = __dp4a(xa[j], wv.z, acc[4 * q + 2]);
        acc[4 * q + 3] = __dp4a(xa[j], wv.w, acc[4 * q + 3]);
      }
    }
  }
}

template <int CA, int CB, int CO, bool PROJ, typename OT>
__global__ void __launch_bounds__(NT)
block_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bsrc,
                const int8_t* __restrict__ w1, const float* __restrict__ g1,
                const float* __restrict__ b1, const int8_t* __restrict__ w2,
                const float* __restrict__ g2, const float* __restrict__ b2,
                const int8_t* __restrict__ wb, const float* __restrict__ gb,
                const float* __restrict__ bb, OT* __restrict__ out, int H,
                int W) {
  using S = BlockS8Shape<CA, CB, CO, PROJ>;
  constexpr int CIN = S::CIN, NG = CO / G;
  extern __shared__ int4 smem_s8[];
  int* w1s = reinterpret_cast<int*>(smem_s8);
  int* w2s = w1s + S::W1;
  int* wbs = w2s + S::W2;
  float* prm = reinterpret_cast<float*>(wbs + S::WB);
  int* xs = reinterpret_cast<int*>(prm + S::PRM);
  int* ms = xs + S::XS;

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * TH, ow0 = blockIdx.x * TW;

  load_s8_weights(w1s, w1, 9, CIN, CO, tid);
  load_s8_weights(w2s, w2, 9, CO, CO, tid);
  if (PROJ) load_s8_weights(wbs, wb, 1, CIN, CO, tid);
  for (int e = tid; e < CO; e += NT) {
    prm[e] = g1[e];
    prm[CO + e] = b1[e];
    prm[2 * CO + e] = g2[e];
    prm[3 * CO + e] = b2[e];
    prm[4 * CO + e] = gb[e];
    prm[5 * CO + e] = bb[e];
  }
  // input tile [a | b] with a two-pixel halo, zero outside the image
  for (int e = tid; e < XH * XW * S::CGI; e += NT) {
    const int c = 4 * (e % S::CGI), pix = e / S::CGI;
    const int ih = oh0 - 2 + pix / XW, iw = ow0 - 2 + pix % XW;
    int v = 0;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
      const long p = ((long)n * H + ih) * W + iw;
      v = c < CA ? *reinterpret_cast<const int*>(a + p * CA + c)
                 : *reinterpret_cast<const int*>(bsrc + p * CB + c - CA);
    }
    xs[pix * S::XWD + c / 4] = v;
  }
  __syncthreads();

  // conv1 + folded BN1 + ReLU, requantized, over the tile and its
  // one-pixel halo -> ms (int8)
  for (int it = tid; it < NG * MH * MW; it += NT) {
    const int grp = it / (MH * MW), pos = it % (MH * MW);
    const int my = pos / MW, mx = pos % MW;
    const int ih = oh0 - 1 + my, iw = ow0 - 1 + mx;
    int* mp = ms + pos * S::MWD + grp * (G / 4);
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) {
#pragma unroll
      for (int j = 0; j < G / 4; ++j) mp[j] = 0;
      continue;
    }
    int acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0;
#pragma unroll 1
    for (int t = 0; t < 9; ++t)
      dot_s8<S::CGI, CO>(acc,
                         xs + ((my + t / 3) * XW + mx + t % 3) * S::XWD,
                         w1s + t * S::CGI * CO + grp * G);
    const float* gg = prm + grp * G;
    const float* bbias = prm + CO + grp * G;
#pragma unroll
    for (int j = 0; j < G; j += 4) {
      int word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float y =
            fmaxf(affine_fma(acc[j + i], gg[j + i], bbias[j + i]), 0.f);
        word |= ((int)rintf(fminf(y, 127.f)) & 0xff) << (8 * i);
      }
      mp[j / 4] = word;
    }
  }
  __syncthreads();

  // conv2 + folded BN2 + pre-add ReLU, bypass, add, ReLU -> out
  for (int it = tid; it < NG * TH * TW; it += NT) {
    const int grp = it / (TH * TW), pos = it % (TH * TW);
    const int py = pos / TW, px = pos % TW;
    const int oh = oh0 + py, ow = ow0 + px;
    if (oh >= H || ow >= W) continue;
    int acc[G];
#pragma unroll
    for (int j = 0; j < G; ++j) acc[j] = 0;
#pragma unroll 1
    for (int t = 0; t < 9; ++t)
      dot_s8<S::CGO, CO>(acc,
                         ms + ((py + t / 3) * MW + px + t % 3) * S::MWD,
                         w2s + t * S::CGO * CO + grp * G);
    float y[G];
    const float* gg = prm + 2 * CO + grp * G;
    const float* bbias = prm + 3 * CO + grp * G;
#pragma unroll
    for (int j = 0; j < G; ++j)
      y[j] = fmaxf(affine_fma(acc[j], gg[j], bbias[j]), 0.f);
    const int* xc = xs + ((py + 2) * XW + px + 2) * S::XWD;  // centre
    const float* gbp = prm + 4 * CO + grp * G;
    const float* bbp = prm + 5 * CO + grp * G;
    if (PROJ) {
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] = 0;
      dot_s8<S::CGI, CO>(acc, xc, wbs + grp * G);
#pragma unroll
      for (int j = 0; j < G; ++j)
        y[j] = __fadd_rn(y[j], affine_fma(acc[j], gbp[j], bbp[j]));
    } else {
      const int8_t* xb = reinterpret_cast<const int8_t*>(xc) + grp * G;
#pragma unroll
      for (int j = 0; j < G; ++j)
        y[j] = __fadd_rn(y[j], affine_fma((int)xb[j], gbp[j], bbp[j]));
    }
#pragma unroll
    for (int j = 0; j < G; ++j) y[j] = fmaxf(y[j], 0.f);
    store_px<G>(out + (((long)n * H + oh) * W + ow) * CO + grp * G, y);
  }
}

template <int CA, int CB, int CO, bool PROJ, typename OT>
int launch(const void* a, const void* b, const void* w1, const void* g1,
           const void* b1, const void* w2, const void* g2, const void* b2,
           const void* wb, const void* gb, const void* bb, void* out, int B,
           int H, int W, cudaStream_t stream) {
  using S = BlockS8Shape<CA, CB, CO, PROJ>;
  static bool smem_set = false;
  cudaError_t e = allow_smem(block_s8_kernel<CA, CB, CO, PROJ, OT>, S::SMEM,
                             &smem_set);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  block_s8_kernel<CA, CB, CO, PROJ, OT><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const int8_t*>(w1), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
      static_cast<const float*>(g2), static_cast<const float*>(b2),
      static_cast<const int8_t*>(wb), static_cast<const float*>(gb),
      static_cast<const float*>(bb), static_cast<OT*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// (ca, cb, co, projection) instantiated: UBR_BASIC_BLOCK_S8_SHAPES, from
// the one table in ops/_build.py:SHAPES. cb = 0 is the single-stream
// block; wb == NULL selects the identity bypass (gb, bb still given);
// out_f32 selects a float output instead of bf16.
UBR_EXPORT int ubr_basic_block_s8(const void* a, const void* b,
                                  const void* w1, const void* g1,
                                  const void* b1, const void* w2,
                                  const void* g2, const void* b2,
                                  const void* wb, const void* gb,
                                  const void* bb, void* out, int B, int H,
                                  int W, int ca, int cb, int co, int out_f32,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool proj = wb != nullptr;
#define UBR_BLOCK_S8(CA, CB, CO, P)                                         \
  if (ca == CA && cb == CB && co == CO && proj == P)                        \
    return out_f32                                                          \
               ? launch<CA, CB, CO, P, float>(a, b, w1, g1, b1, w2, g2, b2, \
                                              wb, gb, bb, out, B, H, W, s)  \
               : launch<CA, CB, CO, P, bf16>(a, b, w1, g1, b1, w2, g2, b2,  \
                                             wb, gb, bb, out, B, H, W, s);
  UBR_BASIC_BLOCK_S8_SHAPES(UBR_BLOCK_S8)
#undef UBR_BLOCK_S8
  return (int)cudaErrorInvalidValue;
}
