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
// across its sequential grid over the two row-parity planes of dy.
//
// Bound on the H100: bytes. 16 x ci x co MACs per x pixel against one x
// and four dy pixels read: 2·16·64·32 / (128 + 4·64) = 171 operations per
// byte at dec2, 2·16·32·16 / (64 + 4·32) = 85 at dec1, below the ~295
// op/B bf16 tensor-core ridge.
//
// Design (tensor cores): per x tile and tap (kr, kc), dW[kr, kc] +=
// x_tileᵀ · dy_tap, a GEMM with M = ci, N = co, K = the tile's pixels (one
// tile row of 16 a k-step), on bf16 mma.sync m16n8k16 with f32
// accumulators.
// - Both operands by ldmatrix.trans from pixel-major swizzled NHWC tiles
//   (the stored rows are pixels, the GEMM's K), as K6 (conv_dw.cu) reads
//   them: A from the x tile, B from dy.
// - Parity planes, as K8 (conv_s2k4.cu) loads them: tap (kr, kc) meets x
//   pixel (i, j) at dy (2i + kr - 1, 2j + kc - 1), stride 2 in the tile,
//   which the chunk swizzle does not spread over the banks. So the haloed
//   dy tile (rows 2 i0 - 1 .. 2 i0 + 2 TH, columns 2 j0 - 1 .. 2 j0 + 2 TW,
//   zero outside dy) lands as its four (row parity, column parity) planes,
//   each swizzled on its own: tap (kr, kc) reads plane (kr & 1, kc & 1) at
//   offset (kr >> 1, kc >> 1), 16 consecutive pixels per k-step.
// - One A serves every tap: x_tileᵀ is the same for all 16, so a warp
//   loads a k-step's A fragments once and runs them against each of its
//   taps' B.
// - Work split: the 16 taps over 8 warps, 2 taps a warp with every M- and
//   n-tile of each — 2 x (ci/16) x (co/8) C fragments, 128 f32 registers
//   a lane at dec2 (one block per SM), 32 at dec1 (two) — so no warp's
//   sums meet another's: no row groups, no reduction in shared memory,
//   and a k-step costs ci/16 + co/8 ldmatrix.x4 for 2 (ci/16)(co/8) MMAs
//   (8 for 32 at dec2). Splitting the taps' parity classes over the grid
//   instead would read x up to four times, a third of the bound's bytes
//   each time; splitting rows over warp groups would double the
//   registers' share of dW or add a shared-memory reduction. Measured
//   against 16 warps of one tap each (64 sums a lane at dec2, 1.5x the A
//   loads per MMA) at b16 on an H100 SXM (700 W): dec2 0.0756 against
//   0.0765 ms, dec1 0.0921 against 0.1053.
// - Tiles: 8x16 x pixels at dec2 (ci = 64: 16 KB of x and 39 KB of planes
//   a buffer), 16x16 at dec1 (16 KB and 37 KB), double-buffered: the next
//   tile arrives by 16-byte cp.async (zero-filled outside x and dy) while
//   this one is computed. 111 KB and 107 KB in all.
// - A persistent grid (SMs x blocks per SM, asked once per kernel instance,
//   at most the wrapper's scratch rows) walks tiles t = blockIdx.x + i *
//   gridDim.x. Each block keeps its share of dW in registers, writes it to
//   its own row of the scratch tensor, and sum_rows (partials.cuh) adds
//   exactly the grid's rows in order, so dW is the same bits on every run.
//   No atomics.
// - Accumulation: each MMA adds into its f32 C, over a block's share of
//   the pixels (about 2000 at b16: 124 k-steps at dec2, 62 at dec1).
//   Against a float64 dW at b16 the tensor cores' truncating adds leave
//   dW within 1.5e-6 (dec2) and 3.0e-6 (dec1) of max|dW|, about twice the
//   f32 plain version's distance and far inside the 1e-4·max gate of the
//   cuda tests, so the k-steps are not promoted as K5's are
//   (conv_gemm.cuh:conv_rows<S, J, true>), whose bias BatchNorm carried.
// - 8-channel streams (dec1 (16, 8) at inplanes 8; dec2 (16, 8) and dec1
//   (8, 4) at 4, under fused_train_deconv): ci = 8 zero-pads the x tile to
//   one 16-channel M-tile (the second chunk zero-filled by its copy; its
//   rows of dW are never written); co = 8 is one n-tile, its B by
//   ldmatrix.x2.trans; co = 4 zero-pads dy's pixels to 8 channels
//   (tc::cp_chunk) and writes 4 columns. 2x to 4x the real MACs.
#include "partials.cuh"
#include "tensor_core.cuh"
#include "ubr_shapes.h"  // UBR_DECONV_DW_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int NWARP = 8, NT = 32 * NWARP;
constexpr int TPW = 16 / NWARP;  // taps a warp
constexpr int TW = 16;           // x columns of a tile: one k-step a row

template <int CI, int CO>
struct DdwShape {
  static constexpr int TH = CI >= 64 ? 8 : 16;      // x rows of a tile
  static constexpr int PH = TH + 1, PW = TW + 1;    // a plane's pixels
  static constexpr int YH = 2 * PH, YW = 2 * PW;    // the haloed dy tile
  // channels of the x tile (M) and of dy's planes (N)
  static constexpr int CIP = tc::pad16(CI), COP = (CO + 7) / 8 * 8;
  static constexpr int NCX = CIP / 8, NCY = COP / 8;  // 16-byte chunks a pixel
  static constexpr int MT = CIP / 16, NT8 = COP / 8;  // M-tiles, n-tiles
  static constexpr int X_ELEMS = TH * TW * CIP;       // bf16 of the x tile
  static constexpr int PLANE = PH * PW * COP;         // bf16 of a plane
  static constexpr int BUF = X_ELEMS + 4 * PLANE;   // bf16 of a buffer
  static constexpr int SMEM = 2 * BUF * 2;
  static constexpr int T = 16 * CI * CO;            // dW elements
  static constexpr int ACC = TPW * MT * NT8 * 4;    // f32 sums a lane
  static constexpr int CAP = ACC > 64 ? 1 : 2;      // blocks an SM
  static_assert(CI % 8 == 0 && CO % 4 == 0 && (NT8 == 1 || NT8 % 2 == 0),
                "x in 16-byte chunks, dy in 8-byte units, n-tile pairs");
};

template <int CI, int CO>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<DdwShape<CI, CO>::SMEM, DdwShape<CI, CO>::CAP>()))
deconv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 float* __restrict__ part, int B, int H, int W) {
  using S = DdwShape<CI, CO>;
  constexpr int TH = S::TH, MT = S::MT, NT8 = S::NT8;
  extern __shared__ uint4 smem[];
  bf16* bufs = reinterpret_cast<bf16*>(smem);  // two (x tile, 4 planes)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q4 = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int H2 = 2 * H, W2 = 2 * W;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;

  // x tile t (zero outside x), then its haloed dy pixel (ry, rx) → plane
  // (ry & 1, rx & 1), pixel (ry >> 1, rx >> 1) of it (zero outside dy)
  auto load = [&](int t, bf16* dst) {
    const int n = t / per_img, r = t % per_img;
    const int i0 = (r / tiles_x) * TH, j0 = (r % tiles_x) * TW;
    for (int e = tid; e < TH * TW * S::NCX; e += NT) {
      const int p = e / S::NCX, c = e % S::NCX;
      const int i = i0 + p / TW, j = j0 + p % TW;
      // a chunk past ci is the tile's padding: zero-filled
      const bool in = i < H && j < W && (S::CIP == CI || c < CI / 8);
      const long pix = in ? ((long)n * H + i) * W + j : 0;
      tc::cp_async16(tc::smem_u32(dst + tc::chunk_at<S::NCX>(p, c) * 8),
                     in ? x + pix * CI + c * 8 : x, in);
    }
    bf16* ys = dst + S::X_ELEMS;
    const int y0 = 2 * i0 - 1, x0 = 2 * j0 - 1;
    for (int e = tid; e < S::YH * S::YW * S::NCY; e += NT) {
      const int p = e / S::NCY, c = e % S::NCY;
      const int ry = p / S::YW, rx = p % S::YW;
      const int iy = y0 + ry, ix = x0 + rx;
      const bool in = iy >= 0 && iy < H2 && ix >= 0 && ix < W2;
      const long pix = in ? ((long)n * H2 + iy) * W2 + ix : 0;
      const int pp = (ry >> 1) * S::PW + (rx >> 1);
      const uint32_t d = tc::smem_u32(
          ys + ((ry & 1) * 2 + (rx & 1)) * S::PLANE +
          tc::chunk_at<S::NCY>(pp, c) * 8);
      if constexpr (CO % 8 == 0)
        tc::cp_async16(d, dy + pix * CO + c * 8, in);
      else  // co = 4: half a chunk, zero-padded
        tc::cp_chunk<CO * 2>(d, dy, dy + pix * CO, c, in);
    }
    tc::cp_async_commit();
  };

  // ldmatrix.trans rows of the lane: A matrix mi holds pixels 8 (mi >> 1)
  // .. of the k-step's tile row and channels 8 (mi & 1) .. of the M-tile;
  // B matrix mi pixels 8 (mi & 1) .. of the plane row and n-tile
  // 2 np + (mi >> 1) of a pair. This warp's taps 2 warp, 2 warp + 1:
  // plane (kr & 1, kc & 1) at offset (kr >> 1, kc >> 1).
  const int apix = r8 + 8 * (mi >> 1), achunk = mi & 1;
  const int bchunk = mi >> 1;
  uint32_t pbase[TPW];
  int poff[TPW];
#pragma unroll
  for (int j = 0; j < TPW; ++j) {
    const int kr = (warp * TPW + j) >> 2, kc = (warp * TPW + j) & 3;
    pbase[j] = (uint32_t)(S::X_ELEMS + ((kr & 1) * 2 + (kc & 1)) * S::PLANE) * 2;
    poff[j] = (kr >> 1) * S::PW + (kc >> 1) + r8 + 8 * (mi & 1);
  }

  float acc[TPW][MT][NT8][4];
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < NT8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][m][t][i] = 0.f;

  int buf = 0;
  if ((int)blockIdx.x < ntiles) load(blockIdx.x, bufs);
#pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
    tc::cp_async_wait_all();
    __syncthreads();  // tile t landed; the last tile's reads are done
    if (t + (int)gridDim.x < ntiles)
      load(t + gridDim.x, bufs + (buf ^ 1) * S::BUF);
    const uint32_t bt = tc::smem_u32(bufs + buf * S::BUF);
#pragma unroll 2
    for (int y = 0; y < TH; ++y) {  // k-step: x tile row y
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        tc::ldsm_x4_trans(
            bt + 16u * tc::chunk_at<S::NCX>(y * TW + apix, 2 * m + achunk),
            a[m]);
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int pp = y * S::PW + poff[j];
        uint32_t b[NT8][2];
        if constexpr (NT8 == 1) {  // one n-tile: lanes 0-15 give the rows
          tc::ldsm_x2_trans(bt + pbase[j] + 16u * tc::chunk_at<S::NCY>(pp, 0),
                            b[0]);
        } else {
#pragma unroll
          for (int np = 0; np < NT8 / 2; ++np) {
            uint32_t r[4];
            tc::ldsm_x4_trans(
                bt + pbase[j] +
                    16u * tc::chunk_at<S::NCY>(pp, 2 * np + bchunk),
                r);
            b[2 * np][0] = r[0];
            b[2 * np][1] = r[1];
            b[2 * np + 1][0] = r[2];
            b[2 * np + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int t2 = 0; t2 < NT8; ++t2)
            tc::mma(acc[j][m][t2], a[m], b[t2][0], b[t2][1]);
      }
    }
  }

  // this block's dW: C fragment (j, m, t) holds rows (ci) 16 m + gq (+ 8)
  // and columns (co) 8 t + 2 q4, + 1 of tap 2 warp + j
  float* row = part + (long)blockIdx.x * S::T;
#pragma unroll
  for (int j = 0; j < TPW; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < NT8; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = 16 * m + gq + 8 * h, co = 8 * t + 2 * q4;
          // the padded rows and columns: none
          if ((S::CIP == CI || ci < CI) && (S::COP == CO || co < CO))
            *reinterpret_cast<float2*>(
                row + ((warp * TPW + j) * CI + ci) * CO + co) =
                make_float2(acc[j][m][t][2 * h], acc[j][m][t][2 * h + 1]);
        }
}

template <int CI, int CO>
int launch(const void* x, const void* dy, void* part, void* dw, int B, int H,
           int W, int blocks, cudaStream_t stream) {
  using S = DdwShape<CI, CO>;
  static bool smem_set = false;
  static int most = 0;
  cudaError_t e = allow_smem(deconv_dw_kernel<CI, CO>, S::SMEM, &smem_set);
  if (e == cudaSuccess)
    e = tc::resident_blocks(deconv_dw_kernel<CI, CO>, NT, S::SMEM, &most);
  if (e != cudaSuccess) return (int)e;
  const int grid = blocks < most ? blocks : most;
  deconv_dw_kernel<CI, CO><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<float*>(part), B, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(static_cast<const float*>(part), grid, S::T, 1.f,
                       static_cast<float*>(dw), stream);
}

}  // namespace

// (ci, co) of the deconv instantiated: UBR_DECONV_DW_SHAPES, from the one
// table in ops/_build.py:SHAPES. H, W are x's; x and dy must be 16-byte
// aligned. part is the wrapper's (blocks, 16*ci*co) f32 scratch, blocks at
// most the x tiles; the kernel runs min(blocks, resident blocks) blocks and
// adds that many rows. dw is (4, 4, ci, co) f32.
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
