// K6 conv_dw — weight gradient of the stride-1, odd k x k 'same'
// convolution:
//   dw[kh, kw, ci, co] = sum over b, h, w of
//                        x[b, h + kh - r, w + kw - r, ci] * dy[b, h, w, co]
// with zero padding, bf16 x and dy in, f32 accumulation, f32 out in the
// (k, k, ci, co) layout.
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:pallas_conv_dw (_dw_kernel,
// halo_weights_adjoint), which accumulates dW in VMEM across its
// sequential grid. Here a persistent grid (SMs x blocks per SM, asked
// once per kernel instance, at most the wrapper's scratch rows) walks
// 16x16 pixel tiles t = blockIdx.x + i * gridDim.x; each block keeps its
// share of dW in registers, writes it to its own row of the scratch
// tensor, and sum_rows (partials.cuh) adds the rows in order, so dW is
// the same bits on every run.
//
// Bound on the H100: bytes at 1x1 and for the classifier; operations or
// bytes near the ridge at 3x3 and 7x7 (k*k*ci*co MACs per pixel against
// 2*(ci + co) bytes read: 9*32*32 MACs per 128 bytes at (32,32,3)).
//
// Design (tensor cores): per tile, dW += A · B with
//   M = k*k*ci (tap-major, then ci), N = co (padded to 8 for co = 3),
//   K = the tile's 256 pixels, one tile row (16 pixels) a k-step,
// on bf16 mma.sync m16n8k16 with f32 accumulators. Both operands come
// straight from the pixel-major NHWC tiles by ldmatrix.trans (the stored
// rows are pixels, the GEMM's K): A from the haloed x tile at the tap's
// offset (one M-tile = 16 channels of one tap), B from the dy tile
// (zeroed outside the image). The tiles arrive by double-buffered
// cp.async while the previous tile is computed; chunks are swizzled
// (tensor_core.cuh:chunk_at) so 8 consecutive pixels hit 8 bank groups.
// Work split: each warp owns WM M-tiles x all n-tiles (A read once per
// k-step and M-tile, B once per k-step and warp); WG warps cover the M
// tiles, and G such groups split a tile's rows (the small shapes, whose
// dW is a few M-tiles), their sums meeting in shared memory in group
// order at the end.
//
// 8-channel streams (inplanes 8 and 4: ci = 8 at 3x3, 1x1 and the 7x7
// head, co = 16, 8 or 4): the x tile is zero-padded to 16 channels
// (tc::pad16; its second chunk zero-filled by the copy), so an M-tile is
// still 16 channels of one tap, half of them zero rows whose sums are
// never written; co = 4 takes the co = 3 path (dy zero-padded to 8
// columns). 2x the real MACs.
#include "partials.cuh"
#include "tensor_core.cuh"
#include "ubr_shapes.h"  // UBR_CONV_DW_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int TH = 16, TW = 16, TP = TH * TW;

// M-tiles a warp: the largest divisor of mt whose accumulators (wm x nt8
// fragments of 4 f32) fit 64 registers.
constexpr int pick_wm(int mt, int nt8) {
  int best = 1;
  for (int d = 1; d <= mt; ++d)
    if (mt % d == 0 && d * nt8 <= 16) best = d;
  return best;
}

template <int CI, int CO, int K>
struct DwShape {
  static constexpr int R = K / 2, TAPS = K * K;
  static constexpr int XH = TH + K - 1, XW = TW + K - 1;
  static constexpr int CIP = tc::pad16(CI);         // channels of x's tile
  static constexpr int NCX = CIP / 8;                // x chunks a pixel
  static constexpr int COP = (CO + 7) / 8 * 8;       // padded N
  static constexpr int NCD = COP / 8, NT8 = COP / 8;  // dy chunks, n-tiles
  static constexpr int MT = TAPS * CIP / 16;         // M-tiles
  static constexpr int WM = pick_wm(MT, NT8);        // M-tiles a warp
  static constexpr int WG = MT / WM;                 // warps a group
  static constexpr int G = WG >= 8 ? 1 : 8 / WG;     // row groups
  static constexpr int NT = 32 * WG * G;
  static constexpr int X_ELEMS = XH * XW * CIP, D_ELEMS = TP * COP;
  static constexpr int T = TAPS * CI * CO;           // dW elements
  static constexpr int TILES = 2 * (X_ELEMS + D_ELEMS) * 2;
  static constexpr int RED = G > 1 ? T * 4 : 0;
  static constexpr int SMEM = TILES > RED ? TILES : RED;
  static constexpr int CAP = WM * NT8 > 8 ? 2 : 3;   // blocks an SM
  static_assert(CI % 8 == 0, "ci: whole 16-byte chunks");
};

template <int CI, int CO, int K>
__global__ void __launch_bounds__(
    DwShape<CI, CO, K>::NT,
    (tc::blocks_per_sm<DwShape<CI, CO, K>::SMEM, DwShape<CI, CO, K>::CAP>()))
conv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               float* __restrict__ part, int B, int H, int W) {
  using S = DwShape<CI, CO, K>;
  constexpr int WM = S::WM, NT8 = S::NT8, NT = S::NT;
  extern __shared__ uint4 smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // two x tiles
  bf16* ds = xs + 2 * S::X_ELEMS;            // two dy tiles
  float* red = reinterpret_cast<float*>(smem);  // group sums, at the end

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / S::WG, wg = warp % S::WG;
  const int gq = lane >> 2, q4 = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;

  auto load = [&](int t, int buf) {
    const int n = t / per_img, r = t % per_img;
    const int oh0 = (r / tiles_x) * TH, ow0 = (r % tiles_x) * TW;
    bf16* xd = xs + buf * S::X_ELEMS;
    for (int e = tid; e < S::XH * S::XW * S::NCX; e += NT) {
      const int p = e / S::NCX, c = e % S::NCX;
      const int ih = oh0 - S::R + p / S::XW, iw = ow0 - S::R + p % S::XW;
      // a chunk past ci is the tile's padding: zero-filled
      const bool in =
          ih >= 0 && ih < H && iw >= 0 && iw < W &&
          (S::CIP == CI || c < CI / 8);
      const long pix = in ? ((long)n * H + ih) * W + iw : 0;
      tc::cp_async16(tc::smem_u32(xd + tc::chunk_at<S::NCX>(p, c) * 8),
                     in ? x + pix * CI + c * 8 : x, in);
    }
    bf16* dd = ds + buf * S::D_ELEMS;
    if constexpr (CO % 8 == 0) {
      for (int e = tid; e < TP * S::NCD; e += NT) {
        const int p = e / S::NCD, c = e % S::NCD;
        const int oh = oh0 + p / TW, ow = ow0 + p % TW;
        const bool in = oh < H && ow < W;
        const long pix = in ? ((long)n * H + oh) * W + ow : 0;
        tc::cp_async16(tc::smem_u32(dd + tc::chunk_at<S::NCD>(p, c) * 8),
                       dy + pix * CO + c * 8, in);
      }
    } else {  // co = 3 or 4: pixels of 6 or 8 bytes, no cp.async;
              // zero-pad to 8
      for (int p = tid; p < TP; p += NT) {
        const int oh = oh0 + p / TW, ow = ow0 + p % TW;
        const bool in = oh < H && ow < W;
        const bf16* src = dy + (in ? ((long)n * H + oh) * W + ow : 0) * CO;
        bf16 v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          v[c] = in && c < CO ? src[c] : __float2bfloat16(0.f);
        *reinterpret_cast<uint4*>(dd + p * 8) =
            make_uint4(tc::pack_bf16(v[0], v[1]), tc::pack_bf16(v[2], v[3]),
                       tc::pack_bf16(v[4], v[5]), tc::pack_bf16(v[6], v[7]));
      }
    }
    tc::cp_async_commit();
  };

  // this warp's M-tiles: tap and channel chunk pair of each; the lane's
  // A row address (ldmatrix.trans: matrix mi = lane / 8 holds pixels
  // 8 (mi / 2) .. and channels 8 (mi % 2) .. of the M-tile) and B row
  // (matrix mi: pixels 8 (mi % 2) .., n-tile mi / 2 of a pair)
  int xoff[WM], achunk[WM];
#pragma unroll
  for (int j = 0; j < WM; ++j) {
    const int m0 = (wg * WM + j) * 16, tap = m0 / S::CIP;
    xoff[j] = (tap / K) * S::XW + tap % K + r8 + 8 * (mi >> 1);
    achunk[j] = (m0 % S::CIP) / 8 + (mi & 1);
  }
  const int bpix = r8 + 8 * (mi & 1), bchunk = mi >> 1;

  float acc[WM][NT8][4];
#pragma unroll
  for (int j = 0; j < WM; ++j)
#pragma unroll
    for (int t = 0; t < NT8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = 0.f;

  int buf = 0;
  if ((int)blockIdx.x < ntiles) load(blockIdx.x, 0);
#pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
    tc::cp_async_wait_all();
    __syncthreads();  // tile t landed; the last tile's reads are done
    if (t + (int)gridDim.x < ntiles) load(t + gridDim.x, buf ^ 1);
    const uint32_t xt = tc::smem_u32(xs + buf * S::X_ELEMS);
    const uint32_t dt = tc::smem_u32(ds + buf * S::D_ELEMS);
#pragma unroll 2
    for (int y = grp; y < TH; y += S::G) {  // k-step: tile row y
      uint32_t b[NT8][2];
      const int pd = y * TW + bpix;
      if constexpr (NT8 == 1) {
        tc::ldsm_x2_trans(dt + 16u * tc::chunk_at<S::NCD>(pd, 0), b[0]);
      } else {
#pragma unroll
        for (int np = 0; np < NT8 / 2; ++np) {
          uint32_t r[4];
          tc::ldsm_x4_trans(
              dt + 16u * tc::chunk_at<S::NCD>(pd, 2 * np + bchunk), r);
          b[2 * np][0] = r[0];
          b[2 * np][1] = r[1];
          b[2 * np + 1][0] = r[2];
          b[2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int j = 0; j < WM; ++j) {
        uint32_t a[4];
        tc::ldsm_x4_trans(
            xt + 16u * tc::chunk_at<S::NCX>(y * S::XW + xoff[j], achunk[j]),
            a);
#pragma unroll
        for (int t2 = 0; t2 < NT8; ++t2) tc::mma(acc[j][t2], a, b[t2][0], b[t2][1]);
      }
    }
  }

  // this block's dW: C fragment (j, t): rows m0 + gq (+ 8), columns
  // 8 t + 2 q4 (+ 1); row m is tap m / CIP, channel m % CIP, and a row
  // of the (k, k, ci, co) layout is tap ci + channel (padded channels
  // have no row).
  auto each = [&](auto&& f) {
#pragma unroll
    for (int j = 0; j < WM; ++j)
#pragma unroll
      for (int t = 0; t < NT8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = (wg * WM + j) * 16 + gq + 8 * (i >> 1);
          const int c = t * 8 + 2 * q4 + (i & 1);
          if constexpr (S::CIP == CI) {
            if (c < CO) f(m * CO + c, acc[j][t][i]);
          } else {
            const int tap = m / S::CIP, ch = m % S::CIP;
            if (c < CO && ch < CI) f((tap * CI + ch) * CO + c, acc[j][t][i]);
          }
        }
  };
  float* row = part + (long)blockIdx.x * S::T;
  if constexpr (S::G == 1) {
    each([&](int e, float v) { row[e] = v; });
  } else {
    __syncthreads();  // tiles done: shared memory takes the group sums
#pragma unroll 1
    for (int g = 0; g < S::G; ++g) {
      if (grp == g) {
        if (g == 0)
          each([&](int e, float v) { red[e] = v; });
        else
          each([&](int e, float v) { red[e] += v; });
      }
      __syncthreads();
    }
    for (int e = tid; e < S::T; e += NT) row[e] = red[e];
  }
}

template <int CI, int CO, int K>
int launch(const void* x, const void* dy, void* part, void* dw, int B, int H,
           int W, int blocks, cudaStream_t stream) {
  using S = DwShape<CI, CO, K>;
  static bool smem_set = false;
  static int most = 0;
  cudaError_t e = allow_smem(conv_dw_kernel<CI, CO, K>, S::SMEM, &smem_set);
  if (e == cudaSuccess)
    e = tc::resident_blocks(conv_dw_kernel<CI, CO, K>, S::NT, S::SMEM, &most);
  if (e != cudaSuccess) return (int)e;
  const int grid = blocks < most ? blocks : most;
  conv_dw_kernel<CI, CO, K><<<grid, S::NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<float*>(part), B, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(static_cast<const float*>(part), grid, S::T, 1.f,
                       static_cast<float*>(dw), stream);
}

}  // namespace

// (ci, co, k) instantiated: UBR_CONV_DW_SHAPES, from the one table in
// ops/_build.py:SHAPES. part is the wrapper's (blocks, k*k*ci*co) f32
// scratch, blocks at most the 16x16 tiles; the kernel runs min(blocks,
// resident blocks) blocks and adds that many rows. dw is (k, k, ci, co)
// f32.
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
