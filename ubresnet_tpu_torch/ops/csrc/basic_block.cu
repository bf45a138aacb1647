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
// Bound on the H100 (b16, bf16 tensor cores at 989 TFLOP/s, 3.35 TB/s):
// bytes, except enc1.res1 (16 -> 32 channels at 256^2), which sits at
// the ops/bytes ridge: 30.1 GFLOP (0.0304 ms) against 101 MB (0.0301
// ms). The dec1 blocks (512^2, 16 channels) move the most bytes: 403 MB
// (res1) and 268 MB (res2), 0.120 and 0.080 ms.
//
// Design (tensor cores): conv1, conv2 and the 1x1 bypass are implicit
// GEMMs (M = pixels of the tile, N = co, K = taps x channels, tap-major)
// on bf16 mma.sync m16n8k16 with f32 accumulators.
// - Tiles of 16x16 output pixels (m 18x18, x 20x20): conv1 recomputes
//   1.27x of m for the halo and x is read 1.56x, against 1.41x and 1.88x
//   for the first form's 8x16 tiles.
// - Weights once per block: a persistent grid (SMs x blocks per SM)
//   walks tiles t = blockIdx.x + k * gridDim.x. Each block lays w1, w2
//   and wb out once as bf16 B fragments in shared memory (59 KB at
//   dec2.res1) — the first form converted them to f32 for every 8x16
//   tile, 0.49 GB of weight reads per layer.
// - Double-buffered cp.async: the next tile's 20x20 x tile (both streams
//   in dual mode, zero-filled outside the image) arrives while this one
//   runs conv1, conv2 and the epilogue.
// - ldmatrix A fragments straight from the pixel-major x and m tiles,
//   each lane giving its pixel's chunk at the tap's offset; chunks are
//   swizzled (tensor_core.cuh) against bank conflicts.
// - Work split: conv1's 21 M-tiles of 16 m pixels over 8 warps (up to 3
//   a warp, sharing each B fragment); conv2 and the bypass take two
//   output rows a warp, so no thread idles at co = 16 (the first form
//   left half the block idle in conv2 there). conv1's accumulators go
//   through BN1 + ReLU, are rounded to bf16 and stored to the m tile
//   (zero outside the image); the bypass has its own accumulators, added
//   after BN2 + ReLU; the identity bypass is read from the x tile.
// - The output is staged in the m tile once conv2 is done with it and
//   written as whole rows with 16-byte coalesced stores.
// Shared memory per shape (weights + 2 x tiles + m tile + affines):
// enc1.res1 28 + 25 + 20.3 KB = 74 KB; enc1.res2 / dec2.res2 36 + 50 +
// 20.3 = 107 KB; dec2.res1 58 + 100 + 20.3 = 179 KB; dec1.res1 14.5 + 50
// + 10.1 = 75 KB; dec1.res2 9 + 25 + 10.1 = 44.5 KB.
//
// Streamed form, for the blocks whose weights, two x tiles and m do not
// fit one block's 227 KB (chosen per shape at compile time,
// BlockShape::STREAM): enc1.res2 / dec2.res2 (64, 0, 64) and dec2.res1
// (64, 64, 64, proj) of the inplanes-32 UResNet, 286 and 474 KB in the
// resident form above (the dual block's w1 + w2 are 216 KB alone). The
// block stays one kernel with m on chip; only the weights move:
// - a prepack kernel lays w1, w2 and wb out once per call as the same B
//   fragments (stage_bv) in the wrapper's scratch, tap by tap contiguous;
// - the main kernel streams them a tap at a time through a two-slot
//   cp.async ring in shared memory (w1's 9 taps, w2's 9, then wb: 19
//   stages a tile), the next stage's copy in flight while this one runs;
// - one x tile (102 KB at 128 channels), loaded at the top of each tile:
//   cp.async groups land in order, so a prefetched x tile would have to
//   land by the first weight stage anyway;
// - conv1 over the 18x18 m tile, BN1 + ReLU into m, conv2, the bypass
//   and the epilogue as the resident form, tap by tap.
// Shared memory: (64, 0, 64) 16 + 1.5 + 51 + 41 = 110 KB; (64, 64, 64)
// 33 + 1.5 + 102 + 41 = 178 KB. A two-block cluster that splits co and
// trades m through distributed shared memory would keep the weights
// resident; not built.
//
// 8-channel streams (the inplanes-8 UResNet's enc1.res1 (8, 0, 16),
// dec1.res.res1 (8, 8, 8) and .res2 (8, 0, 8); at inplanes 4 the last
// two as dec2's blocks and enc1.res2): the tiles are zero-padded to the
// 16-channel k-step (tc::pad16). An 8-channel x stream is one 16-byte
// chunk a pixel; a chunk past the streams' channels is zero-filled by
// its copy; the weights' B rows and columns past the real channels and
// the affines past co are zero, so conv1 writes zeros into m's padded
// channels and conv2 reads them against zero rows. co = 8 computes 16
// columns and stores 8. 2x (co 16) to 4x (8 -> 8) the real MACs, each
// block still bound by bytes; the same function as unpadded.
#include "tensor_core.cuh"
#include "ubr_shapes.h"  // UBR_BASIC_BLOCK_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 16, TW = 16;
constexpr int MH = TH + 2, MW = TW + 2;  // m: one-pixel halo
constexpr int XH = TH + 4, XW = TW + 4;  // x: two-pixel halo
constexpr int NWARP = 8, NT = 32 * NWARP;
constexpr int MT1 = (MH * MW + 15) / 16;       // conv1 M-tiles (21)
constexpr int J1 = (MT1 + NWARP - 1) / NWARP;  // conv1 M-tiles a warp
constexpr int J2 = TH / NWARP;                 // output rows a warp

template <int CA, int CB, int CO, bool PROJ>
struct BlockShape {
  static constexpr int CIN = CA + CB, COUT = CO;     // real channels
  // channels of the x and m tiles and of the GEMMs' K and N
  static constexpr int CIP = tc::pad16(CIN), COP = tc::pad16(CO);
  static constexpr int NCI = CIP / 8, NCO = COP / 8;  // 16-byte chunks/pixel
  static constexpr int NQ = COP / 16;                 // n-tile pairs
  static constexpr int W1_UNITS = 9 * CIP * COP / 8;  // uint4 of B fragments
  static constexpr int W2_UNITS = 9 * COP * COP / 8;
  static constexpr int WB_UNITS = PROJ ? CIP * COP / 8 : 0;
  static constexpr int PRM = 6 * COP;  // g1 b1 g2 b2 gb bb (f32)
  static constexpr int X_ELEMS = XH * XW * CIP, M_ELEMS = MH * MW * COP;
  static constexpr int RESIDENT = (W1_UNITS + W2_UNITS + WB_UNITS) * 16 +
                                  PRM * 4 + (2 * X_ELEMS + M_ELEMS) * 2;
  // streamed form: the weights a tap at a time through a two-slot ring
  static constexpr bool STREAM = RESIDENT > tc::SMEM_MAX;
  static constexpr int W1_TAP = CIP * COP / 8, W2_TAP = COP * COP / 8;
  static constexpr int SLOT = W1_TAP > W2_TAP ? W1_TAP : W2_TAP;
  static constexpr int NSTAGE = 18 + (PROJ ? 1 : 0);  // w1, w2 taps, wb
  static constexpr int STREAMED = 2 * SLOT * 16 + PRM * 4 +
                                  (X_ELEMS + M_ELEMS) * 2;
  static constexpr int SMEM = STREAM ? STREAMED : RESIDENT;
  // 64 output channels: the accumulators want the registers of one block
  static constexpr int CAP = CO >= 64 ? 1 : 2;
  static_assert(CA % 8 == 0 && CB % 8 == 0 && CO % 8 == 0,
                "streams of whole 16-byte chunks");
  static_assert(TH * TW * COP <= M_ELEMS, "output staging fits the m tile");
  static_assert(PROJ || CIN == CO, "identity bypass needs ci == co");
  static_assert(SMEM <= tc::SMEM_MAX, "one block's shared memory");
};

template <int NQ, int J>
__device__ __forceinline__ void zero(float (&acc)[J][2 * NQ][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int nt = 0; nt < 2 * NQ; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.f;
}

// acc[j] += A_j · B over one tap's KC k-steps: lane's A row of M-tile j
// is tile pixel pix[j] + shift, chunk 2 kc + half; B fragments wf
// (stage_bv layout, the tap's k-steps). M-tiles with on[j] false are
// skipped.
template <int NC, int KC, int NQ, int J>
__device__ __forceinline__ void gemm_tap(float (&acc)[J][2 * NQ][4],
                                         uint32_t tile, const uint4* wf,
                                         const int (&pix)[J],
                                         const bool (&on)[J], int lane,
                                         int shift) {
  const int ah = tc::a_half(lane);
  uint32_t off[J];
#pragma unroll
  for (int j = 0; j < J; ++j) off[j] = tc::a_off<NC>(pix[j] + shift, ah);
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint4 bq[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) bq[q] = wf[(kc * NQ + q) * 32 + lane];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (!on[j]) continue;
      uint32_t a[4];
      tc::ldsm_x4(tile + (off[j] ^ (kc << 5)), a);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        tc::mma(acc[j][2 * q], a, bq[q].x, bq[q].y);
        tc::mma(acc[j][2 * q + 1], a, bq[q].z, bq[q].w);
      }
    }
  }
}

// The tap (dy, dx) = (tap / 3, tap % 3) as a pixel shift in a tile of row
// pitch PW (a 1x1 conv: no shift).
template <int TAPS, int PW>
__device__ __forceinline__ int tap_shift(int tap) {
  return TAPS == 1 ? 0 : (tap / 3) * PW + tap % 3;
}

// acc[j] += A_j · B over TAPS x KC k-steps (gemm_tap per tap) in a tile
// of row pitch PW; B fragments wf (stage_bv layout, K tap-major).
template <int NC, int KC, int TAPS, int NQ, int J, int PW>
__device__ __forceinline__ void gemm(float (&acc)[J][2 * NQ][4],
                                     uint32_t tile, const uint4* wf,
                                     const int (&pix)[J], const bool (&on)[J],
                                     int lane) {
#pragma unroll
  for (int tap = 0; tap < TAPS; ++tap)
    gemm_tap<NC, KC, NQ, J>(acc, tile, wf + tap * KC * NQ * 32, pix, on, lane,
                            tap_shift<TAPS, PW>(tap));
}


// Start the copy of the x tile [a | b] of tile t with a two-pixel halo
// (zero outside the image) into dst, as one cp.async group.
template <class S, int CA, int CB>
__device__ __forceinline__ void load_x(bf16* dst, const bf16* __restrict__ a,
                                       const bf16* __restrict__ bsrc, int t,
                                       int tiles_x, int per_img, int H, int W,
                                       int tid) {
  constexpr int NCI = S::NCI;
  const int n = t / per_img, r = t % per_img;
  const int y0 = (r / tiles_x) * TH - 2, x0 = (r % tiles_x) * TW - 2;
  for (int e = tid; e < XH * XW * NCI; e += NT) {
    const int p = e / NCI, c = e % NCI;
    const int ih = y0 + p / XW, iw = x0 + p % XW;
    // a chunk past the streams' channels is padding: zero-filled
    const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W &&
                    (S::CIP == CA + CB || c < (CA + CB) / 8);
    const long pix = ((long)n * H + ih) * W + iw;
    const bf16* src = a;
    if (in)
      src = c < CA / 8 ? a + pix * CA + c * 8 : bsrc + pix * CB + c * 8 - CA;
    tc::cp_async16(tc::smem_u32(dst + tc::chunk_at<NCI>(p, c) * 8), src, in);
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

// conv1's accumulators through BN1 + ReLU, rounded to bf16, into the m
// tile (zero outside the image).
template <class S>
__device__ __forceinline__ void conv1_to_m(
    const float (&acc)[J1][2 * S::NQ][4], bf16* ms, const float* prm,
    const bool (&on1)[J1], int oh0, int ow0, int H, int W, int warp,
    int lane) {
  constexpr int CO = S::NCO * 8, NCO = S::NCO;
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
        const float y0 =
            in ? fmaxf(acc[j][nt][2 * h] * gg.x + be.x, 0.f) : 0.f;
        const float y1 =
            in ? fmaxf(acc[j][nt][2 * h + 1] * gg.y + be.y, 0.f) : 0.f;
        *reinterpret_cast<bf162*>(ms + tc::elem_at<NCO>(mi, ch)) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

// BN2 + pre-add ReLU, bypass (accb, or the identity from the x tile xt),
// add, ReLU -> staging in the m tile (pixel py*TW+px, once every warp is
// done reading m), then this warp's output rows as 16-byte chunks.
template <class S, bool PROJ>
__device__ __forceinline__ void epilogue(
    const float (&acc)[J2][2 * S::NQ][4],
    const float (&accb)[J2][2 * S::NQ][4], const bf16* xt, bf16* ms,
    const float* prm, bf16* __restrict__ out, int n, int oh0, int ow0,
    int H, int W, int warp, int lane) {
  constexpr int CO = S::NCO * 8, NCO = S::NCO, NCI = S::NCI;
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 2 * S::NQ; ++nt) {
    const int ch = nt * 8 + 2 * q4;
    const float2 gg = *reinterpret_cast<const float2*>(prm + 2 * CO + ch);
    const float2 be = *reinterpret_cast<const float2*>(prm + 3 * CO + ch);
    float2 gr = make_float2(0.f, 0.f), br = gr;
    if constexpr (PROJ) {
      gr = *reinterpret_cast<const float2*>(prm + 4 * CO + ch);
      br = *reinterpret_cast<const float2*>(prm + 5 * CO + ch);
    }
#pragma unroll
    for (int j = 0; j < J2; ++j) {
      const int py = warp * J2 + j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = g + 8 * h;
        float r0, r1;
        if constexpr (PROJ) {
          r0 = accb[j][nt][2 * h] * gr.x + br.x;
          r1 = accb[j][nt][2 * h + 1] * gr.y + br.y;
        } else {
          const float2 xv =
              ld_bf16x2(xt + tc::elem_at<NCI>((py + 2) * XW + px + 2, ch));
          r0 = xv.x;
          r1 = xv.y;
        }
        const float y0 =
            fmaxf(fmaxf(acc[j][nt][2 * h] * gg.x + be.x, 0.f) + r0, 0.f);
        const float y1 =
            fmaxf(fmaxf(acc[j][nt][2 * h + 1] * gg.y + be.y, 0.f) + r1, 0.f);
        *reinterpret_cast<bf162*>(ms + tc::elem_at<NCO>(py * TW + px, ch)) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
  __syncwarp();
  // this warp's output rows, whole 16-byte chunks of the real channels
  constexpr int COUT = S::COUT, NCR = COUT / 8;
  for (int e = lane; e < J2 * TW * NCR; e += 32) {
    const int sp = warp * J2 * TW + e / NCR, c = e % NCR;
    const int oh = oh0 + sp / TW, ow = ow0 + sp % TW;
    if (oh < H && ow < W)
      *reinterpret_cast<uint4*>(out + (((long)n * H + oh) * W + ow) * COUT +
                                c * 8) =
          *reinterpret_cast<const uint4*>(ms + tc::chunk_at<NCO>(sp, c) * 8);
  }
}

// The folded affines g1 b1 g2 b2 gb bb (f32) into shared memory, each
// COP long (zero past co).
template <class S, bool PROJ>
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
    prm[4 * COP + e] = PROJ && on ? gb[e] : 0.f;
    prm[5 * COP + e] = PROJ && on ? bb[e] : 0.f;
  }
}

// w1 (3, 3, cin, co), w2 (3, 3, co, co) and wb (cin, co) as B fragments
// (stage_bv) over the tiles' padded channels: K row tap * CIP + c, zero
// past the real channels (rows) and past co (columns); in [w1 | w2 | wb]
// order at w1f, w2f, wbf.
template <class S, bool PROJ>
__device__ __forceinline__ void stage_weights(uint4* w1f, uint4* w2f,
                                              uint4* wbf,
                                              const bf16* __restrict__ w1,
                                              const bf16* __restrict__ w2,
                                              const bf16* __restrict__ wb,
                                              int tid, int n) {
  constexpr int CIN = S::CIN, CIP = S::CIP, CO = S::COUT, COP = S::COP;
  const bf16 z = __float2bfloat16(0.f);
  tc::stage_bv<9 * CIP, COP>(
      w1f,
      [&](int k, int c) {
        const int t = k / CIP, ch = k % CIP;
        return ch < CIN && c < CO ? w1[(t * CIN + ch) * CO + c] : z;
      },
      tid, n);
  tc::stage_bv<9 * COP, COP>(
      w2f,
      [&](int k, int c) {
        const int t = k / COP, ch = k % COP;
        return ch < CO && c < CO ? w2[(t * CO + ch) * CO + c] : z;
      },
      tid, n);
  if constexpr (PROJ)
    tc::stage_bv<CIP, COP>(
        wbf,
        [&](int k, int c) { return k < CIN && c < CO ? wb[k * CO + c] : z; },
        tid, n);
}

// The resident form: every weight in shared memory for the whole grid
// walk, x tiles double-buffered.
template <int CA, int CB, int CO, bool PROJ>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<BlockShape<CA, CB, CO, PROJ>::SMEM,
                           BlockShape<CA, CB, CO, PROJ>::CAP>()))
basic_block_kernel(const bf16* __restrict__ a, const bf16* __restrict__ bsrc,
                   const bf16* __restrict__ w1, const float* __restrict__ g1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ g2, const float* __restrict__ b2,
                   const bf16* __restrict__ wb, const float* __restrict__ gb,
                   const float* __restrict__ bb, bf16* __restrict__ out,
                   int B, int H, int W) {
  using S = BlockShape<CA, CB, CO, PROJ>;
  constexpr int CIP = S::CIP, COP = S::COP, NCI = S::NCI, NCO = S::NCO;
  constexpr int NQ = S::NQ;
  extern __shared__ uint4 smem[];
  uint4* w1f = smem;
  uint4* w2f = w1f + S::W1_UNITS;
  uint4* wbf = w2f + S::W2_UNITS;
  float* prm = reinterpret_cast<float*>(wbf + S::WB_UNITS);
  bf16* xs = reinterpret_cast<bf16*>(prm + S::PRM);
  bf16* ms = xs + 2 * S::X_ELEMS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;

  stage_weights<S, PROJ>(w1f, w2f, wbf, w1, w2, wb, tid, NT);
  stage_prm<S, PROJ>(prm, g1, b1, g2, b2, gb, bb, tid);

  const Pixels px(warp, tc::a_row(lane));
  const uint32_t ms_u = tc::smem_u32(ms);
  int buf = 0;
  if ((int)blockIdx.x < ntiles)
    load_x<S, CA, CB>(xs, a, bsrc, blockIdx.x, tiles_x, per_img, H, W, tid);
#pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
    tc::cp_async_wait_all();
    __syncthreads();  // x of tile t landed; the last tile's reads are done
    if (t + (int)gridDim.x < ntiles)
      load_x<S, CA, CB>(xs + (buf ^ 1) * S::X_ELEMS, a, bsrc, t + gridDim.x,
                        tiles_x, per_img, H, W, tid);
    const bf16* xt = xs + buf * S::X_ELEMS;
    const uint32_t xt_u = tc::smem_u32(xt);
    const int n = t / per_img, r = t % per_img;
    const int oh0 = (r / tiles_x) * TH, ow0 = (r % tiles_x) * TW;

    {  // conv1 + BN1 + ReLU over the tile and its halo -> m (bf16)
      float acc[J1][2 * NQ][4];
      zero<NQ>(acc);
      gemm<NCI, CIP / 16, 9, NQ, J1, XW>(acc, xt_u, w1f, px.pix1, px.on1,
                                         lane);
      conv1_to_m<S>(acc, ms, prm, px.on1, oh0, ow0, H, W, warp, lane);
    }
    __syncthreads();  // m complete

    float acc[J2][2 * NQ][4], accb[J2][2 * NQ][4];
    zero<NQ>(acc);
    gemm<NCO, COP / 16, 9, NQ, J2, MW>(acc, ms_u, w2f, px.pix2, px.on2, lane);
    if constexpr (PROJ) {
      zero<NQ>(accb);
      gemm<NCI, CIP / 16, 1, NQ, J2, XW>(accb, xt_u, wbf, px.pixb, px.on2,
                                         lane);
    }
    __syncthreads();  // every warp is done reading m: it becomes staging
    epilogue<S, PROJ>(acc, accb, xt, ms, prm, out, n, oh0, ow0, H, W, warp,
                      lane);
  }
}

// The streamed form's weights, once per call: w1, w2 and wb as B
// fragments (stage_bv layout) in the wrapper's scratch wf — [w1 | w2 |
// wb], each tap's k-steps contiguous — over a grid of any size.
template <int CA, int CB, int CO, bool PROJ>
__global__ void __launch_bounds__(NT)
prepack_kernel(const bf16* __restrict__ w1, const bf16* __restrict__ w2,
               const bf16* __restrict__ wb, uint4* __restrict__ wf) {
  using S = BlockShape<CA, CB, CO, PROJ>;
  stage_weights<S, PROJ>(wf, wf + S::W1_UNITS, wf + S::W1_UNITS + S::W2_UNITS,
                         w1, w2, wb, blockIdx.x * NT + threadIdx.x,
                         gridDim.x * NT);
}

// The streamed form (see the top of the file): per tile, NSTAGE weight
// stages through a two-slot ring, stage k's slot k & 1 (k counts stages
// over the whole grid walk), one x tile.
template <int CA, int CB, int CO, bool PROJ>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<BlockShape<CA, CB, CO, PROJ>::SMEM,
                           BlockShape<CA, CB, CO, PROJ>::CAP>()))
basic_block_streamed_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ bsrc,
    const uint4* __restrict__ wf, const float* __restrict__ g1,
    const float* __restrict__ b1, const float* __restrict__ g2,
    const float* __restrict__ b2, const float* __restrict__ gb,
    const float* __restrict__ bb, bf16* __restrict__ out, int B, int H,
    int W) {
  using S = BlockShape<CA, CB, CO, PROJ>;
  constexpr int CIP = S::CIP, COP = S::COP, NCI = S::NCI, NCO = S::NCO;
  constexpr int NQ = S::NQ, NSTAGE = S::NSTAGE, SLOT = S::SLOT;
  extern __shared__ uint4 smem[];
  uint4* ring = smem;
  float* prm = reinterpret_cast<float*>(ring + 2 * SLOT);
  bf16* xs = reinterpret_cast<bf16*>(prm + S::PRM);
  bf16* ms = xs + S::X_ELEMS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;
  stage_prm<S, PROJ>(prm, g1, b1, g2, b2, gb, bb, tid);

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
  int k = 0;  // stages so far; the next tile's stage 0 follows stage
              // NSTAGE - 1, if this block has a next tile
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

    {  // conv1 + BN1 + ReLU over the tile and its halo -> m (bf16)
      float acc[J1][2 * NQ][4];
      zero<NQ>(acc);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++k) {
        advance(tap, t);
        gemm_tap<NCI, CIP / 16, NQ, J1>(acc, xs_u, ring + (k & 1) * SLOT,
                                        px.pix1, px.on1, lane,
                                        tap_shift<9, XW>(tap));
      }
      conv1_to_m<S>(acc, ms, prm, px.on1, oh0, ow0, H, W, warp, lane);
    }
    // m is complete once every warp is past conv2's first advance

    float acc[J2][2 * NQ][4], accb[J2][2 * NQ][4];
    zero<NQ>(acc);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap, ++k) {
      advance(9 + tap, t);
      gemm_tap<NCO, COP / 16, NQ, J2>(acc, ms_u, ring + (k & 1) * SLOT,
                                     px.pix2, px.on2, lane,
                                     tap_shift<9, MW>(tap));
    }
    if constexpr (PROJ) {
      zero<NQ>(accb);
      advance(18, t);
      gemm_tap<NCI, CIP / 16, NQ, J2>(accb, xs_u, ring + (k & 1) * SLOT,
                                      px.pixb, px.on2, lane, 0);
      ++k;
    }
    __syncthreads();  // every warp is done reading m: it becomes staging
    epilogue<S, PROJ>(acc, accb, xs, ms, prm, out, n, oh0, ow0, H, W, warp,
                      lane);
  }
  tc::cp_async_wait_all();
}

template <int CA, int CB, int CO, bool PROJ>
int launch(const void* a, const void* b, const void* w1, const void* g1,
           const void* b1, const void* w2, const void* g2, const void* b2,
           const void* wb, const void* gb, const void* bb, void* wf,
           void* out, int B, int H, int W, cudaStream_t stream) {
  using S = BlockShape<CA, CB, CO, PROJ>;
  static bool smem_set = false;
  static int most = 0;
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if constexpr (S::STREAM) {
    auto kernel = basic_block_streamed_kernel<CA, CB, CO, PROJ>;
    cudaError_t e = allow_smem(kernel, S::SMEM, &smem_set);
    if (e == cudaSuccess) e = tc::resident_blocks(kernel, NT, S::SMEM, &most);
    if (e != cudaSuccess) return (int)e;
    if (wf == nullptr) return (int)cudaErrorInvalidValue;
    if (tiles == 0) return 0;
    constexpr int UNITS = S::W1_UNITS + S::W2_UNITS + S::WB_UNITS;
    prepack_kernel<CA, CB, CO, PROJ><<<(UNITS + NT - 1) / NT, NT, 0, stream>>>(
        static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
        static_cast<const bf16*>(wb), static_cast<uint4*>(wf));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int grid = (int)(tiles < most ? tiles : most);
    kernel<<<grid, NT, S::SMEM, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<const uint4*>(wf), static_cast<const float*>(g1),
        static_cast<const float*>(b1), static_cast<const float*>(g2),
        static_cast<const float*>(b2), static_cast<const float*>(gb),
        static_cast<const float*>(bb), static_cast<bf16*>(out), B, H, W);
  } else {
    auto kernel = basic_block_kernel<CA, CB, CO, PROJ>;
    cudaError_t e = allow_smem(kernel, S::SMEM, &smem_set);
    if (e == cudaSuccess) e = tc::resident_blocks(kernel, NT, S::SMEM, &most);
    if (e != cudaSuccess) return (int)e;
    if (tiles == 0) return 0;
    const int grid = (int)(tiles < most ? tiles : most);
    kernel<<<grid, NT, S::SMEM, stream>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(b),
        static_cast<const bf16*>(w1), static_cast<const float*>(g1),
        static_cast<const float*>(b1), static_cast<const bf16*>(w2),
        static_cast<const float*>(g2), static_cast<const float*>(b2),
        static_cast<const bf16*>(wb), static_cast<const float*>(gb),
        static_cast<const float*>(bb), static_cast<bf16*>(out), B, H, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// (ca, cb, co, projection) instantiated: UBR_BASIC_BLOCK_SHAPES, from
// the one table in ops/_build.py:SHAPES. cb = 0 is the single-stream
// block; wb == NULL selects the identity bypass. wf is the wrapper's
// scratch for the streamed form's weight fragments (the weights' own
// size in bytes: w1, w2 and wb); the resident form does not read it.
UBR_EXPORT int ubr_basic_block(const void* a, const void* b, const void* w1,
                               const void* g1, const void* b1, const void* w2,
                               const void* g2, const void* b2, const void* wb,
                               const void* gb, const void* bb, void* wf,
                               void* out, int B, int H, int W, int ca, int cb,
                               int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool proj = wb != nullptr;
#define UBR_BLOCK(CA, CB, CO, P)                                            \
  if (ca == CA && cb == CB && co == CO && proj == P)                        \
    return launch<CA, CB, CO, P>(a, b, w1, g1, b1, w2, g2, b2, wb, gb, bb, \
                                 wf, out, B, H, W, s);
  UBR_BASIC_BLOCK_SHAPES(UBR_BLOCK)
#undef UBR_BLOCK
  return (int)cudaErrorInvalidValue;
}
