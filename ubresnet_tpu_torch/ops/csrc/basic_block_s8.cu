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
// under the ~590 op/B int8 ridge).
//
// Design: basic_block.cu's (K2) carried to int8.
// - conv1, conv2 and the 1x1 bypass are implicit GEMMs (M = pixels of the
//   tile, N = co, K = taps x channels, tap-major) on
//   mma.sync.m16n8k32.s32.s8.s8.s32 (tensor_core.cuh:mma_s8), exact s32
//   accumulators. A 16-byte chunk holds 16 int8 channels (1, 2 or 4 a
//   pixel at 16, 32 or 64) and a k-step 32, two chunks: the same bytes
//   as bf16 K2's 16-channel k-step, so the A fragments come by ldmatrix at
//   the same swizzled lane addresses. At 16 channels (enc1.res1's conv1
//   and bypass, the co = 16 conv2s and dec1.res2's conv1) a k-step covers
//   two taps — lanes 0-15 address the first tap's pixel, lanes 16-31 the
//   second's — and the 9 taps are padded by a phantom tenth whose weight
//   rows are zero, as K1 does at ci = 4.
// - 16x16 output tiles with m recomputed over 18x18 (x 20x20), in a
//   persistent grid (SMs x blocks per SM, asked once per kernel instance)
//   walking tiles t = blockIdx.x + k * gridDim.x. Each block lays w1, w2
//   and wb out once as s8 B fragments in shared memory (stage_b_s8), so
//   the weights are read once per block, not once per tile.
// - Double-buffered cp.async: the next tile's 20x20 int8 x tile (both
//   streams in dual mode, zero-filled outside the image) arrives while
//   this one runs conv1, conv2 and the epilogue.
// - conv1's 21 M-tiles of 16 m pixels over 8 warps (up to 3 a warp,
//   sharing each B fragment); conv2 and the bypass two output rows a warp.
// - The epilogue is basic_block_s8_plain's f32 arithmetic step for step:
//   affine_fma, fmaxf, rintf(fminf(y, 127)) into the int8 m tile (zero
//   outside the image), the bypass affine_fma of the s32 1x1 sum or of
//   the identity's int8 x, __fadd_rn, the final fmaxf. s32 sums are exact
//   in any order, so the f32 output is bit-identical to
//   basic_block_s8_plain's.
// - Each warp stages its two output rows (bf16 or float) in its own
//   swizzled shared-memory rows and writes them as 16-byte chunks.
// Shared memory (weights + 2 x tiles + m + staging, bf16 / f32 out, in
// units of 1000 bytes): enc1.res1 15.4 + 12.8 + 10.4 + 16.4 / 32.8 =
// 56 / 72; enc1.res2 and dec2.res2 18.4 + 25.6 + 10.4 + 16.4 / 32.8 =
// 72 / 88; dec2.res1 29.7 + 51.2 + 10.4 + 16.4 / 32.8 = 108 / 125;
// dec1.res1 7.7 + 25.6 + 5.2 + 8.2 / 16.4 = 47 / 55; dec1.res2 5.1 +
// 12.8 + 5.2 + 8.2 / 16.4 = 32 / 40: two blocks an SM (one for
// dec2.res1's f32 form).
//
// Streamed form (BlockS8Shape::STREAM, chosen per shape at compile time):
// dec2.res1 of the inplanes-32 UResNet, (64, 64, 64, proj), needs 270 /
// 302 KB resident (bf16 / f32 out). As in K2's streamed form
// (basic_block.cu), a prepack kernel lays w1, w2 and wb out once per call
// as the same s8 B fragments in the wrapper's scratch, the main kernel
// streams them a tap at a time through a two-slot cp.async ring (19
// stages a tile) and holds one x tile; m, the epilogue and its
// arithmetic are the resident form's, so the float32 output stays
// bit-identical to basic_block_s8_plain's. Shared memory: 16.4 + 1.5 +
// 51.2 + 20.7 + 32.8 / 65.5 = 123 / 155 KB.
//
// 8-channel streams (K2's 8-channel blocks, basic_block.cu): an int8
// stream of 8 channels is 8 bytes a pixel, so the x tile is copied in
// 8-byte units ([a | b] of the dual block fill one 16-byte chunk;
// enc1.res1's and .res2's single stream fills half of one, the other
// half zero-filled by its copy) and the tiles hold 16 channels (the
// 16-channel two-taps-a-k-step mode above); m, the B columns, the
// affines and the staged outputs are padded to 16 channels with zeros,
// co = 8 stores 8. 4x (2x at co 16) the real MACs; the s32 sums of the
// real channels are the unpadded ones, so the float32 output stays
// bit-identical to basic_block_s8_plain's.
#include "tensor_core.cuh"
#include "ubr_shapes.h"  // UBR_BASIC_BLOCK_S8_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 16, TW = 16;
constexpr int MH = TH + 2, MW = TW + 2;  // m: one-pixel halo
constexpr int XH = TH + 4, XW = TW + 4;  // x: two-pixel halo
constexpr int NWARP = 8, NT = 32 * NWARP;
constexpr int MT1 = (MH * MW + 15) / 16;       // conv1 M-tiles (21)
constexpr int J1 = (MT1 + NWARP - 1) / NWARP;  // conv1 M-tiles a warp
constexpr int J2 = TH / NWARP;                 // output rows a warp

// 32-channel k-steps of a conv over TAPS taps of C int8 channels: C / 32
// a tap, or at C = 16 two taps a step (the last one's second a phantom).
constexpr int ksteps(int taps, int c) {
  return c >= 32 ? taps * (c / 32) : (taps + 1) / 2;
}

template <int CA, int CB, int CO, bool PROJ, typename OT>
struct BlockS8Shape {
  static constexpr int CIN = CA + CB, COUT = CO;  // real channels
  // channels of the x and m tiles and of the GEMMs' K and N
  static constexpr int CIP = tc::pad16(CIN), COP = tc::pad16(CO);
  static constexpr int NCI = CIP / 16, NCO = COP / 16;  // int8 chunks/pixel
  static constexpr int NQ = COP / 16;                   // n-tile pairs
  static constexpr int NCS = COP * (int)sizeof(OT) / 16;  // staged chunks
  static constexpr int KS1 = ksteps(9, CIP), KS2 = ksteps(9, COP);
  static constexpr int KSB = ksteps(1, CIP);
  static constexpr int W1_UNITS = KS1 * NQ * 32;  // uint4 of B fragments
  static constexpr int W2_UNITS = KS2 * NQ * 32;
  static constexpr int WB_UNITS = PROJ ? KSB * NQ * 32 : 0;
  static constexpr int PRM = 6 * COP;  // g1 b1 g2 b2 gb bb (f32)
  static constexpr int X_BYTES = XH * XW * CIP, M_BYTES = MH * MW * COP;
  static constexpr int ST = J2 * TW * COP;  // staged outputs a warp
  static constexpr int STAGING = NWARP * ST * (int)sizeof(OT);
  static constexpr int RESIDENT = (W1_UNITS + W2_UNITS + WB_UNITS) * 16 +
                                  PRM * 4 + 2 * X_BYTES + M_BYTES + STAGING;
  // streamed form: the weights a tap at a time through a two-slot ring
  // (at 32 channels or more a tap is whole k-steps)
  static constexpr bool STREAM = RESIDENT > tc::SMEM_MAX;
  static constexpr int W1_TAP = CIP * COP / 16, W2_TAP = COP * COP / 16;
  static constexpr int SLOT = W1_TAP > W2_TAP ? W1_TAP : W2_TAP;
  static constexpr int NSTAGE = 18 + (PROJ ? 1 : 0);  // w1, w2 taps, wb
  static constexpr int STREAMED = 2 * SLOT * 16 + PRM * 4 + X_BYTES +
                                  M_BYTES + STAGING;
  static constexpr int SMEM = STREAM ? STREAMED : RESIDENT;
  static constexpr int CAP = CO >= 64 ? 1 : 2;  // blocks an SM (registers)
  static_assert(CA % 8 == 0 && CB % 8 == 0 && CO % 8 == 0,
                "int8 channels in 8-byte units");
  // 8-byte copies where a stream is no whole number of 16-byte chunks
  static constexpr bool UNITS8 = CA % 16 != 0 || CB % 16 != 0;
  static_assert(PROJ || CIN == CO, "identity bypass needs ci == co");
  static_assert(!STREAM || (CIP >= 32 && COP >= 32),
                "the streamed form moves whole k-steps a tap");
  static_assert(SMEM <= tc::SMEM_MAX, "one block's shared memory");
};

template <int NQ, int J>
__device__ __forceinline__ void zero(int (&acc)[J][2 * NQ][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int nt = 0; nt < 2 * NQ; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0;
}

// acc[j] += A_j · B over one tap of C >= 32 int8 channels (C / 32
// k-steps): lane's A row of M-tile j is tile pixel pix[j] + shift, chunk
// 2 kc + half; B fragments wf (stage_b_s8 layout, the tap's k-steps).
// M-tiles with on[j] false are skipped.
template <int C, int NQ, int J>
__device__ __forceinline__ void gemm_tap(int (&acc)[J][2 * NQ][4],
                                         uint32_t tile, const uint4* wf,
                                         const int (&pix)[J],
                                         const bool (&on)[J], int lane,
                                         int shift) {
  static_assert(C >= 32, "whole k-steps a tap");
  constexpr int NC = C / 16, KC = C / 32;
  const int ah = tc::a_half(lane);
  uint32_t off0[J];
#pragma unroll
  for (int j = 0; j < J; ++j) off0[j] = tc::a_off<NC>(pix[j] + shift, ah);
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint4 bq[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) bq[q] = wf[(kc * NQ + q) * 32 + lane];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!on[j]) continue;
      uint32_t a[4];
      tc::ldsm_x4(tile + (off0[j] ^ (kc << 5)), a);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        tc::mma_s8(acc[j][2 * q], a, bq[q].x, bq[q].y);
        tc::mma_s8(acc[j][2 * q + 1], a, bq[q].z, bq[q].w);
      }
    }
  }
}

// acc[j] += A_j · B over a conv of TAPS taps (3x3 or 1x1) and C int8
// channels: the lane's A row of M-tile j is tile pixel pix[j] shifted by
// the tap (tap / 3, tap % 3) in a tile of row pitch PW; B fragments wf
// (stage_b_s8 layout, K tap-major). M-tiles with on[j] false are skipped.
template <int C, int TAPS, int NQ, int J, int PW>
__device__ __forceinline__ void gemm(int (&acc)[J][2 * NQ][4], uint32_t tile,
                                     const uint4* wf, const int (&pix)[J],
                                     const bool (&on)[J], int lane) {
  if constexpr (C >= 32) {
    // C / 32 k-steps a tap
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap)
      gemm_tap<C, NQ, J>(acc, tile, wf + tap * (C / 32) * NQ * 32, pix, on,
                         lane, (tap / 3) * PW + tap % 3);
  } else {
    // C = 16, one chunk a pixel: two taps a k-step, lanes 16-31 on the
    // second (the last step's second tap is the phantom: its B rows are
    // zero, it reads tap TAPS - 1)
    const int ah = tc::a_half(lane);
#pragma unroll
    for (int s = 0; s < (TAPS + 1) / 2; ++s) {
      const int tap = min(2 * s + ah, TAPS - 1);
      const int shift = (tap / 3) * PW + tap % 3;
      uint4 bq[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) bq[q] = wf[(s * NQ + q) * 32 + lane];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!on[j]) continue;
        uint32_t a[4];
        tc::ldsm_x4(tile + 16u * (uint32_t)(pix[j] + shift), a);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          tc::mma_s8(acc[j][2 * q], a, bq[q].x, bq[q].y);
          tc::mma_s8(acc[j][2 * q + 1], a, bq[q].z, bq[q].w);
        }
      }
    }
  }
}

// relu(acc * g + b) requantized to the int8 grid: rint(min(y, 127)).
__device__ __forceinline__ int requant(int acc, float g, float b) {
  const float y = fmaxf(affine_fma(acc, g, b), 0.f);
  return (int)rintf(fminf(y, 127.f));
}

// Start the copy of the int8 x tile [a | b] of tile t with a two-pixel
// halo (zero outside the image) into dst, as one cp.async group.
template <class S, int CA, int CB>
__device__ __forceinline__ void load_x(int8_t* dst,
                                       const int8_t* __restrict__ a,
                                       const int8_t* __restrict__ bsrc, int t,
                                       int tiles_x, int per_img, int H, int W,
                                       int tid) {
  constexpr int NCI = S::NCI;
  const int n = t / per_img, r = t % per_img;
  const int y0 = (r / tiles_x) * TH - 2, x0 = (r % tiles_x) * TW - 2;
  if constexpr (S::UNITS8) {
    // 8-byte unit u of a tile pixel: a's, then b's, then zeros
    for (int e = tid; e < XH * XW * 2 * NCI; e += NT) {
      const int p = e / (2 * NCI), u = e % (2 * NCI);
      const int ih = y0 + p / XW, iw = x0 + p % XW;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W &&
                      u < (CA + CB) / 8;
      const long pix = ((long)n * H + ih) * W + iw;
      const int8_t* src = a;
      if (in)
        src = u < CA / 8 ? a + pix * CA + u * 8
                         : bsrc + pix * CB + (u - CA / 8) * 8;
      tc::cp_async8(
          tc::smem_u32(dst + tc::chunk_at<NCI>(p, u >> 1) * 16 + (u & 1) * 8),
          src, in);
    }
  } else {
    for (int e = tid; e < XH * XW * NCI; e += NT) {
      const int p = e / NCI, c = e % NCI;
      const int ih = y0 + p / XW, iw = x0 + p % XW;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const long pix = ((long)n * H + ih) * W + iw;
      const int8_t* src = a;
      if (in)
        src = c < CA / 16 ? a + pix * CA + c * 16
                          : bsrc + pix * CB + (c - CA / 16) * 16;
      tc::cp_async16(tc::smem_u32(dst + tc::chunk_at<NCI>(p, c) * 16), src,
                     in);
    }
  }
  tc::cp_async_commit();
}

// Lane's A pixels: conv1 M-tile j covers m pixels 16 (warp + 8j) ..,
// conv2 / bypass M-tile j is output row warp * J2 + j.
struct Pixels {
  int pix1[J1], pix2[J2], pixb[J2];
  bool on1[J1], on2[J2];
  __device__ __forceinline__ Pixels(int warp, int ar) {
#pragma unroll
    for (int j = 0; j < J1; ++j) {
      const int mt = warp + NWARP * j;
      const int mi = min(mt * 16 + ar, MH * MW - 1);
      pix1[j] = (mi / MW) * XW + mi % MW;
      on1[j] = mt < MT1;
    }
#pragma unroll
    for (int j = 0; j < J2; ++j) {
      pix2[j] = (warp * J2 + j) * MW + ar;
      pixb[j] = (warp * J2 + j + 2) * XW + ar + 2;
      on2[j] = true;
    }
  }
};

// conv1's sums through the folded BN1 + ReLU, requantized, into the int8
// m tile (zero outside the image).
template <class S>
__device__ __forceinline__ void conv1_to_m(const int (&acc)[J1][2 * S::NQ][4],
                                           int8_t* ms, const float* prm,
                                           const bool (&on1)[J1], int oh0,
                                           int ow0, int H, int W, int warp,
                                           int lane) {
  constexpr int CO = S::NQ * 16, NCO = S::NCO;
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * S::NQ; ++nt) {
    const int ch = nt * 8 + 2 * q4;
    const float2 gg = *reinterpret_cast<const float2*>(prm + ch);
    const float2 be = *reinterpret_cast<const float2*>(prm + CO + ch);
#pragma unroll
    for (int j = 0; j < J1; ++j) {
      if (!on1[j]) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mi = (warp + NWARP * j) * 16 + g + 8 * h;
        if (mi >= MH * MW) continue;
        const int ih = oh0 - 1 + mi / MW, iw = ow0 - 1 + mi % MW;
        const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
        const int v0 = in ? requant(acc[j][nt][2 * h], gg.x, be.x) : 0;
        const int v1 = in ? requant(acc[j][nt][2 * h + 1], gg.y, be.y) : 0;
        *reinterpret_cast<uint16_t*>(ms + tc::elem_at<NCO, 16>(mi, ch)) =
            (uint16_t)(v0 | (v1 << 8));
      }
    }
  }
}

// Folded BN2 + pre-add ReLU, bypass (accb, or the identity's int8 x from
// the x tile xt), add, ReLU -> this warp's staging wst (pixel j * TW +
// px), then its output rows as 16-byte chunks.
template <class S, bool PROJ, typename OT>
__device__ __forceinline__ void epilogue(const int (&acc)[J2][2 * S::NQ][4],
                                         const int (&accb)[J2][2 * S::NQ][4],
                                         const int8_t* xt, OT* wst,
                                         const float* prm,
                                         OT* __restrict__ out, int n, int oh0,
                                         int ow0, int H, int W, int warp,
                                         int lane) {
  constexpr int CO = S::NQ * 16, NCI = S::NCI, NCS = S::NCS;
  constexpr int ES = 16 / (int)sizeof(OT);
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * S::NQ; ++nt) {
    const int ch = nt * 8 + 2 * q4;
    const float2 gg = *reinterpret_cast<const float2*>(prm + 2 * CO + ch);
    const float2 be = *reinterpret_cast<const float2*>(prm + 3 * CO + ch);
    const float2 gr = *reinterpret_cast<const float2*>(prm + 4 * CO + ch);
    const float2 br = *reinterpret_cast<const float2*>(prm + 5 * CO + ch);
#pragma unroll
    for (int j = 0; j < J2; ++j) {
      const int py = warp * J2 + j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = g + 8 * h;
        float r0, r1;
        if constexpr (PROJ) {
          r0 = affine_fma(accb[j][nt][2 * h], gr.x, br.x);
          r1 = affine_fma(accb[j][nt][2 * h + 1], gr.y, br.y);
        } else {
          const int8_t* xv =
              xt + tc::elem_at<NCI, 16>((py + 2) * XW + px + 2, ch);
          r0 = affine_fma((int)xv[0], gr.x, br.x);
          r1 = affine_fma((int)xv[1], gr.y, br.y);
        }
        const float y0 = fmaxf(
            __fadd_rn(fmaxf(affine_fma(acc[j][nt][2 * h], gg.x, be.x), 0.f),
                      r0),
            0.f);
        const float y1 = fmaxf(
            __fadd_rn(
                fmaxf(affine_fma(acc[j][nt][2 * h + 1], gg.y, be.y), 0.f),
                r1),
            0.f);
        put2(wst + tc::elem_at<NCS, ES>(j * TW + px, ch), y0, y1);
      }
    }
  }
  __syncwarp();
  tc::store_rows<NCS, J2, S::COUT>(out, wst, n, oh0 + warp * J2, ow0, H, W,
                                   lane);
  __syncwarp();  // staging read before the next tile's epilogue
}

// The folded affines g1 b1 g2 b2 gb bb (f32) into shared memory, each
// COP long (zero past co).
template <class S>
__device__ __forceinline__ void stage_prm(float* prm, const float* g1,
                                          const float* b1, const float* g2,
                                          const float* b2, const float* gb,
                                          const float* bb, int tid) {
  constexpr int CO = S::COUT, COP = S::COP;
  for (int e = tid; e < COP; e += NT) {
    const bool on = e < CO;
    prm[e] = on ? g1[e] : 0.f;
    prm[COP + e] = on ? b1[e] : 0.f;
    prm[2 * COP + e] = on ? g2[e] : 0.f;
    prm[3 * COP + e] = on ? b2[e] : 0.f;
    prm[4 * COP + e] = on ? gb[e] : 0.f;
    prm[5 * COP + e] = on ? bb[e] : 0.f;
  }
}

// B row k of a (taps, c, co) int8 kernel over the tile's padded
// channels cp: tap k / cp, channel k % cp — the layout itself read as a
// K x co matrix where cp == c; zero past the last tap, the real
// channels (rows) and co (columns).
template <class S, bool PROJ>
__device__ __forceinline__ void stage_weights(uint4* w1f, uint4* w2f,
                                              uint4* wbf,
                                              const int8_t* __restrict__ w1,
                                              const int8_t* __restrict__ w2,
                                              const int8_t* __restrict__ wb,
                                              int tid, int n) {
  constexpr int CIN = S::CIN, CIP = S::CIP, CO = S::COUT, COP = S::COP;
  tc::stage_b_s8<S::KS1, COP>(
      w1f,
      [&](int k, int c) {
        const int t = k / CIP, ch = k % CIP;
        return t < 9 && ch < CIN && c < CO ? w1[(t * CIN + ch) * CO + c] : 0;
      },
      tid, n);
  tc::stage_b_s8<S::KS2, COP>(
      w2f,
      [&](int k, int c) {
        const int t = k / COP, ch = k % COP;
        return t < 9 && ch < CO && c < CO ? w2[(t * CO + ch) * CO + c] : 0;
      },
      tid, n);
  if constexpr (PROJ)
    tc::stage_b_s8<S::KSB, COP>(
        wbf,
        [&](int k, int c) { return k < CIN && c < CO ? wb[k * CO + c] : 0; },
        tid, n);
}

// The resident form: every weight in shared memory for the whole grid
// walk, x tiles double-buffered.
template <int CA, int CB, int CO, bool PROJ, typename OT>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<BlockS8Shape<CA, CB, CO, PROJ, OT>::SMEM,
                           BlockS8Shape<CA, CB, CO, PROJ, OT>::CAP>()))
basic_block_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bsrc,
                const int8_t* __restrict__ w1, const float* __restrict__ g1,
                const float* __restrict__ b1, const int8_t* __restrict__ w2,
                const float* __restrict__ g2, const float* __restrict__ b2,
                const int8_t* __restrict__ wb, const float* __restrict__ gb,
                const float* __restrict__ bb, OT* __restrict__ out, int B,
                int H, int W) {
  using S = BlockS8Shape<CA, CB, CO, PROJ, OT>;
  constexpr int CIP = S::CIP, COP = S::COP, NQ = S::NQ;
  extern __shared__ uint4 smem[];
  uint4* w1f = smem;
  uint4* w2f = w1f + S::W1_UNITS;
  uint4* wbf = w2f + S::W2_UNITS;
  float* prm = reinterpret_cast<float*>(wbf + S::WB_UNITS);
  int8_t* xs = reinterpret_cast<int8_t*>(prm + S::PRM);
  int8_t* ms = xs + 2 * S::X_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;
  OT* wst = reinterpret_cast<OT*>(ms + S::M_BYTES) + warp * S::ST;

  stage_weights<S, PROJ>(w1f, w2f, wbf, w1, w2, wb, tid, NT);
  stage_prm<S>(prm, g1, b1, g2, b2, gb, bb, tid);

  const Pixels px(warp, tc::a_row(lane));
  const uint32_t ms_u = tc::smem_u32(ms);
  int buf = 0;
  if ((int)blockIdx.x < ntiles)
    load_x<S, CA, CB>(xs, a, bsrc, blockIdx.x, tiles_x, per_img, H, W, tid);
#pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
    tc::cp_async_wait_all();
    __syncthreads();  // x of tile t landed; the last tile's m reads are done
    if (t + (int)gridDim.x < ntiles)
      load_x<S, CA, CB>(xs + (buf ^ 1) * S::X_BYTES, a, bsrc, t + gridDim.x,
                        tiles_x, per_img, H, W, tid);
    const int8_t* xt = xs + buf * S::X_BYTES;
    const uint32_t xt_u = tc::smem_u32(xt);
    const int n = t / per_img, r = t % per_img;
    const int oh0 = (r / tiles_x) * TH, ow0 = (r % tiles_x) * TW;

    {  // conv1 + folded BN1 + ReLU, requantized, over the tile and its
       // halo -> m (int8, zero outside the image)
      int acc[J1][2 * NQ][4];
      zero<NQ>(acc);
      gemm<CIP, 9, NQ, J1, XW>(acc, xt_u, w1f, px.pix1, px.on1, lane);
      conv1_to_m<S>(acc, ms, prm, px.on1, oh0, ow0, H, W, warp, lane);
    }
    __syncthreads();  // m complete

    int acc[J2][2 * NQ][4], accb[J2][2 * NQ][4];
    zero<NQ>(acc);
    gemm<COP, 9, NQ, J2, MW>(acc, ms_u, w2f, px.pix2, px.on2, lane);
    if constexpr (PROJ) {
      zero<NQ>(accb);
      gemm<CIP, 1, NQ, J2, XW>(accb, xt_u, wbf, px.pixb, px.on2, lane);
    }
    epilogue<S, PROJ, OT>(acc, accb, xt, wst, prm, out, n, oh0, ow0, H, W,
                          warp, lane);
  }
}

// The streamed form's weights, once per call: w1, w2 and wb as s8 B
// fragments (stage_b_s8 layout) in the wrapper's scratch wf — [w1 | w2 |
// wb], each tap's k-steps contiguous — over a grid of any size.
template <int CA, int CB, int CO, bool PROJ, typename OT>
__global__ void __launch_bounds__(NT)
prepack_s8_kernel(const int8_t* __restrict__ w1,
                  const int8_t* __restrict__ w2,
                  const int8_t* __restrict__ wb, uint4* __restrict__ wf) {
  using S = BlockS8Shape<CA, CB, CO, PROJ, OT>;
  stage_weights<S, PROJ>(wf, wf + S::W1_UNITS, wf + S::W1_UNITS + S::W2_UNITS,
                         w1, w2, wb, blockIdx.x * NT + threadIdx.x,
                         gridDim.x * NT);
}

// The streamed form (see the top of the file): per tile, NSTAGE weight
// stages through a two-slot ring, stage k's slot k & 1 (k counts stages
// over the whole grid walk), one x tile.
template <int CA, int CB, int CO, bool PROJ, typename OT>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<BlockS8Shape<CA, CB, CO, PROJ, OT>::SMEM,
                           BlockS8Shape<CA, CB, CO, PROJ, OT>::CAP>()))
basic_block_s8_streamed_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ bsrc,
    const uint4* __restrict__ wf, const float* __restrict__ g1,
    const float* __restrict__ b1, const float* __restrict__ g2,
    const float* __restrict__ b2, const float* __restrict__ gb,
    const float* __restrict__ bb, OT* __restrict__ out, int B, int H,
    int W) {
  using S = BlockS8Shape<CA, CB, CO, PROJ, OT>;
  constexpr int CIP = S::CIP, COP = S::COP, NQ = S::NQ;
  constexpr int NSTAGE = S::NSTAGE, SLOT = S::SLOT;
  extern __shared__ uint4 smem[];
  uint4* ring = smem;
  float* prm = reinterpret_cast<float*>(ring + 2 * SLOT);
  int8_t* xs = reinterpret_cast<int8_t*>(prm + S::PRM);
  int8_t* ms = xs + S::X_BYTES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;
  OT* wst = reinterpret_cast<OT*>(ms + S::M_BYTES) + warp * S::ST;
  stage_prm<S>(prm, g1, b1, g2, b2, gb, bb, tid);

  // stage s of a tile: w1 tap s (s < 9), w2 tap s - 9 (s < 18), wb
  auto fetch = [&](int s, int slot) {
    const uint4* src = s < 9    ? wf + s * S::W1_TAP
                       : s < 18 ? wf + S::W1_UNITS + (s - 9) * S::W2_TAP
                                : wf + S::W1_UNITS + S::W2_UNITS;
    const int units = s < 9 || s >= 18 ? S::W1_TAP : S::W2_TAP;
    uint4* dst = ring + slot * SLOT;
    for (int e = tid; e < units; e += NT)
      tc::cp_async16(tc::smem_u32(dst + e), src + e, true);
  };
  int k = 0;  // stages so far
  // Before stage k runs: its weights (and the x tile) landed, every warp
  // is done with stage k - 1, whose slot takes stage k + 1's copy.
  auto advance = [&](int s, int t) {
    __syncthreads();
    if (s + 1 < NSTAGE)
      fetch(s + 1, (k + 1) & 1);
    else if (t + (int)gridDim.x < ntiles)
      fetch(0, (k + 1) & 1);
    tc::cp_async_commit();  // (maybe empty)
    tc::cp_async_wait_group<1>();
    __syncthreads();
  };

  const Pixels px(warp, tc::a_row(lane));
  const uint32_t ms_u = tc::smem_u32(ms), xs_u = tc::smem_u32(xs);
  if ((int)blockIdx.x < ntiles) {
    fetch(0, 0);
    tc::cp_async_commit();
  }
#pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    __syncthreads();  // the last tile's reads of x and m are done
    load_x<S, CA, CB>(xs, a, bsrc, t, tiles_x, per_img, H, W, tid);
    const int n = t / per_img, r = t % per_img;
    const int oh0 = (r / tiles_x) * TH, ow0 = (r % tiles_x) * TW;

    {  // conv1 + folded BN1 + ReLU, requantized -> m
      int acc[J1][2 * NQ][4];
      zero<NQ>(acc);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++k) {
        advance(tap, t);
        gemm_tap<CIP, NQ, J1>(acc, xs_u, ring + (k & 1) * SLOT, px.pix1,
                              px.on1, lane, (tap / 3) * XW + tap % 3);
      }
      conv1_to_m<S>(acc, ms, prm, px.on1, oh0, ow0, H, W, warp, lane);
    }
    // m is complete once every warp is past conv2's first advance

    int acc[J2][2 * NQ][4], accb[J2][2 * NQ][4];
    zero<NQ>(acc);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap, ++k) {
      advance(9 + tap, t);
      gemm_tap<COP, NQ, J2>(acc, ms_u, ring + (k & 1) * SLOT, px.pix2, px.on2,
                           lane, (tap / 3) * MW + tap % 3);
    }
    if constexpr (PROJ) {
      zero<NQ>(accb);
      advance(18, t);
      gemm_tap<CIP, NQ, J2>(accb, xs_u, ring + (k & 1) * SLOT, px.pixb,
                            px.on2, lane, 0);
      ++k;
    }
    epilogue<S, PROJ, OT>(acc, accb, xs, wst, prm, out, n, oh0, ow0, H, W,
                          warp, lane);
  }
  tc::cp_async_wait_all();
}

template <int CA, int CB, int CO, bool PROJ, typename OT>
int launch(const void* a, const void* b, const void* w1, const void* g1,
           const void* b1, const void* w2, const void* g2, const void* b2,
           const void* wb, const void* gb, const void* bb, void* wf,
           void* out, int B, int H, int W, cudaStream_t stream) {
  using S = BlockS8Shape<CA, CB, CO, PROJ, OT>;
  static bool smem_set = false;
  static int most = 0;
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if constexpr (S::STREAM) {
    auto kernel = basic_block_s8_streamed_kernel<CA, CB, CO, PROJ, OT>;
    cudaError_t e = allow_smem(kernel, S::SMEM, &smem_set);
    if (e == cudaSuccess) e = tc::resident_blocks(kernel, NT, S::SMEM, &most);
    if (e != cudaSuccess) return (int)e;
    if (wf == nullptr) return (int)cudaErrorInvalidValue;
    if (tiles == 0) return 0;
    constexpr int UNITS = S::W1_UNITS + S::W2_UNITS + S::WB_UNITS;
    prepack_s8_kernel<CA, CB, CO, PROJ, OT>
        <<<(UNITS + NT - 1) / NT, NT, 0, stream>>>(
            static_cast<const int8_t*>(w1), static_cast<const int8_t*>(w2),
            static_cast<const int8_t*>(wb), static_cast<uint4*>(wf));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int grid = (int)(tiles < most ? tiles : most);
    kernel<<<grid, NT, S::SMEM, stream>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<const uint4*>(wf), static_cast<const float*>(g1),
        static_cast<const float*>(b1), static_cast<const float*>(g2),
        static_cast<const float*>(b2), static_cast<const float*>(gb),
        static_cast<const float*>(bb), static_cast<OT*>(out), B, H, W);
  } else {
    auto kernel = basic_block_s8_kernel<CA, CB, CO, PROJ, OT>;
    cudaError_t e = allow_smem(kernel, S::SMEM, &smem_set);
    if (e == cudaSuccess) e = tc::resident_blocks(kernel, NT, S::SMEM, &most);
    if (e != cudaSuccess) return (int)e;
    if (tiles == 0) return 0;
    const int grid = (int)(tiles < most ? tiles : most);
    kernel<<<grid, NT, S::SMEM, stream>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<const int8_t*>(w1), static_cast<const float*>(g1),
        static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
        static_cast<const float*>(g2), static_cast<const float*>(b2),
        static_cast<const int8_t*>(wb), static_cast<const float*>(gb),
        static_cast<const float*>(bb), static_cast<OT*>(out), B, H, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// (ca, cb, co, projection) instantiated: UBR_BASIC_BLOCK_S8_SHAPES, from
// the one table in ops/_build.py:SHAPES. cb = 0 is the single-stream
// block; wb == NULL selects the identity bypass (gb, bb still given);
// out_f32 selects a float output instead of bf16. a and b must be
// 16-byte aligned. wf is the wrapper's scratch for the streamed form's
// weight fragments (the int8 weights' own bytes); the resident form does
// not read it.
UBR_EXPORT int ubr_basic_block_s8(const void* a, const void* b,
                                  const void* w1, const void* g1,
                                  const void* b1, const void* w2,
                                  const void* g2, const void* b2,
                                  const void* wb, const void* gb,
                                  const void* bb, void* wf, void* out, int B,
                                  int H, int W, int ca, int cb, int co,
                                  int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool proj = wb != nullptr;
#define UBR_BLOCK_S8(CA, CB, CO, P)                                         \
  if (ca == CA && cb == CB && co == CO && proj == P)                        \
    return out_f32                                                          \
               ? launch<CA, CB, CO, P, float>(a, b, w1, g1, b1, w2, g2, b2, \
                                              wb, gb, bb, wf, out, B, H, W, s)  \
               : launch<CA, CB, CO, P, bf16>(a, b, w1, g1, b1, w2, g2, b2,  \
                                             wb, gb, bb, wf, out, B, H, W, s);
  UBR_BASIC_BLOCK_S8_SHAPES(UBR_BLOCK_S8)
#undef UBR_BLOCK_S8
  return (int)cudaErrorInvalidValue;
}
