// The deconv backward's tiles and GEMMs, shared by K8 conv_s2k4 (dx), K9
// deconv_dw (dW) and K10 deconv2x_bwd (both from one read of dy), for
// ConvTranspose2d(k=4, stride=2, padding=1) with x (B, H, W, ci), dy
// (B, 2H, 2W, co) and w (4, 4, ci, co), all bf16 NHWC:
//   dx[b, i, j, ci]     = sum over kr, kc, co of w[kr, kc, ci, co] * dy[.]
//   dW[kr, kc, ci, co]  = sum over b, i, j of x[b, i, j, ci] * dy[.]
// with dy[.] = dy[b, 2i + kr - 1, 2j + kc - 1, co], zero outside dy.
//
// - Tiles. A persistent grid walks x-side tiles of QH x QW pixels (the dx
//   tile of K8, the x tile of K9): block b takes tiles b, b + gridDim.x,
//   .. (row-major over images, tile rows, tile columns), the next tile's
//   copies in flight (double-buffered 16-byte cp.async, zero-filled
//   outside the tensors) while this one is computed (Walk).
// - Parity planes. Tap (kr, kc) meets x-side pixel (i, j) at dy (2i + kr
//   - 1, 2j + kc - 1): stride 2 in the tile, which the chunk swizzle
//   (tensor_core.cuh:chunk_at) does not spread over the banks. So the
//   haloed dy tile (rows 2 i0 - 1 .. 2 i0 + 2 QH, columns 2 j0 - 1 .. 2 j0
//   + 2 QW) lands as its four (row parity, column parity) planes, each a
//   (QH + 1) x (QW + 1) pixel array swizzled on its own: tap (kr, kc)
//   reads plane (kr & 1, kc & 1) at offset (kr >> 1, kc >> 1), 16
//   consecutive pixels per M-tile row or k-step (load_planes).
// - Dx: K8's implicit GEMM of one tile on bf16 mma.sync m16n8k16, f32
//   accumulators: M = the tile's dx pixels (16 a row, J rows a warp), N =
//   ci, K = 16 taps x co tap-major, A by ldmatrix from the planes, B the
//   weights laid out once per block as per-lane fragments.
// - Dw: K9's GEMMs of one tile, dW[kr, kc] += x_tileᵀ · dy_tap (M = ci, N =
//   co, K = the tile's pixels, a tile row a k-step), both operands by
//   ldmatrix.trans; the 16 taps over 8 warps, 2 taps a warp with every M-
//   and n-tile of each, so a warp's sums meet no other warp's and one A
//   fragment serves both its taps.
// - 8-channel streams: an 8-channel x tile is zero-padded to one
//   16-channel M-tile (tc::pad16); dy pixels of 4 or 8 channels are
//   zero-padded to the plane's channels (tc::cp_chunk); the padding's
//   rows and columns are never stored.
#pragma once

#include "tensor_core.cuh"

namespace pt {

constexpr int NWARP = 8, NT = 32 * NWARP;
constexpr int QW = 16;  // x-side columns of a tile: one M-tile or k-step

// x-side rows of a tile: 8 where ci x co is the flagship dec2's (64, 32),
// whose K8 weight fragments take 64 KB and whose 16x16 planes would take
// 74 KB a buffer; 16 below.
template <int CI, int CO>
__host__ __device__ constexpr int tile_rows() {
  return CI * CO >= 64 * 32 ? 8 : 16;
}

// The persistent walk over the x-side tiles of B images of H x W.
template <int QH>
struct Walk {
  int tiles_x, per_img, ntiles;
  __device__ Walk(int B, int H, int W)
      : tiles_x((W + QW - 1) / QW),
        per_img(((W + QW - 1) / QW) * ((H + QH - 1) / QH)),
        ntiles(B * per_img) {}
  // image n and first row i0, column j0 of tile t
  __device__ __forceinline__ void at(int t, int& n, int& i0, int& j0) const {
    n = t / per_img;
    const int r = t % per_img;
    i0 = (r / tiles_x) * QH;
    j0 = (r % tiles_x) * QW;
  }
  // load(t, buf) starts (and commits) tile t's copies into buffer buf;
  // body(t, buf) computes on them once they landed.
  template <typename Load, typename Body>
  __device__ __forceinline__ void run(Load load, Body body) const {
    int buf = 0;
    if ((int)blockIdx.x < ntiles) load((int)blockIdx.x, 0);
#pragma unroll 1
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
      tc::cp_async_wait_all();
      __syncthreads();  // tile t landed; the last tile's reads are done
      if (t + (int)gridDim.x < ntiles) load(t + (int)gridDim.x, buf ^ 1);
      body(t, buf);
    }
  }
};

// Start the copy of tile (n, i0, j0)'s haloed dy window into its four
// parity planes at ``planes``: COP channels a pixel (CO real, the rest
// zero), plane (pr, pc) at planes + (2 pr + pc) * (QH + 1) * (QW + 1) *
// COP, zero outside dy (2H x 2W = H2 x W2). Not committed.
template <int CO, int COP, int QH>
__device__ __forceinline__ void load_planes(bf16* planes,
                                            const bf16* __restrict__ dy,
                                            int n, int i0, int j0, int H2,
                                            int W2, int tid) {
  constexpr int PW = QW + 1, YH = 2 * (QH + 1), YW = 2 * PW;
  constexpr int NC = COP / 8, PLANE = (QH + 1) * PW * COP;
  static_assert(COP % 8 == 0 && COP >= CO, "planes of whole chunks");
  const int y0 = 2 * i0 - 1, x0 = 2 * j0 - 1;
  for (int e = tid; e < YH * YW * NC; e += NT) {
    const int p = e / NC, c = e % NC;
    const int ry = p / YW, rx = p % YW;
    const int iy = y0 + ry, ix = x0 + rx;
    const bool in = iy >= 0 && iy < H2 && ix >= 0 && ix < W2;
    const long pix = in ? ((long)n * H2 + iy) * W2 + ix : 0;
    const int pp = (ry >> 1) * PW + (rx >> 1);
    const uint32_t d =
        tc::smem_u32(planes + ((ry & 1) * 2 + (rx & 1)) * PLANE +
                     tc::chunk_at<NC>(pp, c) * 8);
    if constexpr (COP == CO)
      tc::cp_async16(d, dy + pix * CO + c * 8, in);
    else  // 8-channel streams: the plane's padding zero-filled
      tc::cp_chunk<CO * 2>(d, dy, dy + pix * CO, c, in);
  }
}

// Start the copy of x tile (n, i0, j0): QH x QW pixels of CIP channels
// (CI real; a chunk past them zero), swizzled, zero outside x (H x W).
// Not committed.
template <int CI, int CIP, int QH>
__device__ __forceinline__ void load_x(bf16* dst, const bf16* __restrict__ x,
                                       int n, int i0, int j0, int H, int W,
                                       int tid) {
  constexpr int NCX = CIP / 8;
  for (int e = tid; e < QH * QW * NCX; e += NT) {
    const int p = e / NCX, c = e % NCX;
    const int i = i0 + p / QW, j = j0 + p % QW;
    const bool in = i < H && j < W && (CIP == CI || c < CI / 8);
    const long pix = in ? ((long)n * H + i) * W + j : 0;
    tc::cp_async16(tc::smem_u32(dst + tc::chunk_at<NCX>(p, c) * 8),
                   in ? x + pix * CI + c * 8 : x, in);
  }
}

// K8's GEMM: dx of one tile from its planes (COP = pad16(co) channels).
template <int CI, int CO, int QH>
struct Dx {
  static constexpr int J = QH / NWARP;             // dx rows a warp
  static constexpr int PW = QW + 1;
  static constexpr int COP = tc::pad16(CO);        // channels of a plane
  static constexpr int NC = COP / 8;               // dy chunks a pixel
  static constexpr int KC = COP / 16;              // k-steps a tap
  static constexpr int KSTEPS = 16 * KC;
  static constexpr int NT8 = CI / 8, NCI = CI / 8;  // n-tiles; dx chunks
  static constexpr int B_UNITS = KSTEPS * NT8 * 32;  // uint2 of B fragments
  static constexpr int PLANE = (QH + 1) * PW * COP;  // bf16 of a plane
  static constexpr int ST = J * QW * CI;             // staging bf16 a warp
  static_assert(QH % NWARP == 0, "whole dx rows a warp");
  static_assert(CI % 8 == 0 && CO % 4 == 0,
                "dx in n-tiles of 8; dy pixels of whole 8-byte units");
  // the k-step XOR (bit 5 of a byte offset) must not reach a plane base
  static_assert(KC == 1 || PLANE * 2 % 64 == 0, "plane base alignment");

  // B row kp = tap COP + c (tap-major), column n: w[tap, n, c] (zero
  // past co), as per-lane fragments (tc::stage_b8)
  static __device__ __forceinline__ void stage_w(uint2* wf,
                                                 const bf16* __restrict__ w,
                                                 int tid) {
    tc::stage_b8<KSTEPS, CI>(
        wf,
        [=](int kp, int n) {
          const int tap = kp / COP, c = kp % COP;
          return c < CO ? w[(tap * CI + n) * CO + c] : __float2bfloat16(0.f);
        },
        tid, NT);
  }

  // dx of tile (n, i0, j0) from the planes at shared address yt: this
  // warp's rows warp J .. + J - 1, rounded to bf16, staged in wst and
  // stored with 16-byte rows.
  static __device__ __forceinline__ void tile(bf16* __restrict__ dx,
                                              uint32_t yt, const uint2* wf,
                                              bf16* wst, int n, int i0,
                                              int j0, int H, int W,
                                              int warp, int lane) {
    const int ar = tc::a_row(lane), half = tc::a_half(lane);
    const int gq = lane >> 2, q4 = lane & 3;
    float acc[J][NT8][4];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int t = 0; t < NT8; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][t][i] = 0.f;

#pragma unroll 1
    for (int kr = 0; kr < 4; ++kr) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        // plane (kr & 1, kc & 1) at offset (kr >> 1, kc >> 1); its base
        // (bytes) has no bit in the k-step XOR's place
        const uint32_t pbase = ((kr & 1) * 2 + (kc & 1)) * PLANE * 2;
        uint32_t off0[J];
#pragma unroll
        for (int j = 0; j < J; ++j)
          off0[j] = pbase + tc::a_off<NC>((warp * J + j + (kr >> 1)) * PW +
                                              ar + (kc >> 1),
                                          half);
#pragma unroll
        for (int k2 = 0; k2 < KC; ++k2) {
          const int s = (kr * 4 + kc) * KC + k2;
          uint2 b[NT8];
#pragma unroll
          for (int t = 0; t < NT8; ++t) b[t] = wf[(s * NT8 + t) * 32 + lane];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            uint32_t a[4];
            tc::ldsm_x4(yt + (off0[j] ^ (k2 << 5)), a);
#pragma unroll
            for (int t = 0; t < NT8; ++t)
              tc::mma(acc[j][t], a, b[t].x, b[t].y);
          }
        }
      }
    }

    // epilogue -> this warp's staging (pixel sp = j * QW + px)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sp = j * QW + gq + 8 * h;
#pragma unroll
        for (int t = 0; t < NT8; ++t)
          *reinterpret_cast<bf162*>(wst + tc::elem_at<NCI>(sp, t * 8 + 2 * q4)) =
              __floats2bfloat162_rn(acc[j][t][2 * h], acc[j][t][2 * h + 1]);
      }
    __syncwarp();
    tc::store_rows<NCI, J>(dx, wst, n, i0 + warp * J, j0, H, W, lane);
    __syncwarp();  // staging read before the next tile's epilogue
  }
};

// K9's GEMMs: this warp's two taps of dW over one tile, from the x tile
// (CIP = pad16(ci) channels) and planes of NCY chunks a pixel (at least
// co's), summed into registers across the block's tiles.
template <int CI, int CO, int QH, int NCY>
struct Dw {
  static constexpr int TPW = 16 / NWARP;              // taps a warp
  static constexpr int PW = QW + 1;
  static constexpr int CIP = tc::pad16(CI), NCX = CIP / 8;
  static constexpr int MT = CIP / 16, NT8 = (CO + 7) / 8;  // M-, n-tiles
  static constexpr int PLANE = (QH + 1) * PW * NCY * 8;    // bf16 of a plane
  static constexpr int T = 16 * CI * CO;                   // dW elements
  static constexpr int ACC = TPW * MT * NT8 * 4;           // f32 sums a lane
  static_assert(CI % 8 == 0 && CO % 4 == 0 && (NT8 == 1 || NT8 % 2 == 0),
                "x in 16-byte chunks, dy in 8-byte units, n-tile pairs");
  static_assert(NCY * 8 >= NT8 * 8, "the planes hold every n-tile");
  using Acc = float[TPW][MT][NT8][4];

  // ldmatrix.trans rows of the lane: A matrix mi holds pixels 8 (mi >> 1)
  // .. of the k-step's tile row and channels 8 (mi & 1) .. of the M-tile;
  // B matrix mi pixels 8 (mi & 1) .. of the plane row and n-tile 2 np +
  // (mi >> 1) of a pair. This warp's taps 2 warp, 2 warp + 1 read plane
  // (kr & 1, kc & 1) at offset (kr >> 1, kc >> 1).
  struct Lane {
    int apix, achunk, bchunk;
    uint32_t pbase[TPW];  // bytes from plane (0, 0)
    int poff[TPW];
    __device__ Lane(int warp, int lane) {
      const int mi = lane >> 3, r8 = lane & 7;
      apix = r8 + 8 * (mi >> 1);
      achunk = mi & 1;
      bchunk = mi >> 1;
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int kr = (warp * TPW + j) >> 2, kc = (warp * TPW + j) & 3;
        pbase[j] = (uint32_t)(((kr & 1) * 2 + (kc & 1)) * PLANE) * 2;
        poff[j] = (kr >> 1) * PW + (kc >> 1) + r8 + 8 * (mi & 1);
      }
    }
  };

  static __device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int j = 0; j < TPW; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT8; ++t)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][m][t][i] = 0.f;
  }

  // acc += this warp's taps over the tile: x tile at shared address xt,
  // planes at yt
  static __device__ __forceinline__ void tile(Acc& acc, uint32_t xt,
                                              uint32_t yt, const Lane& ln) {
#pragma unroll 2
    for (int y = 0; y < QH; ++y) {  // k-step: x tile row y
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        tc::ldsm_x4_trans(
            xt + 16u * tc::chunk_at<NCX>(y * QW + ln.apix, 2 * m + ln.achunk),
            a[m]);
#pragma unroll
      for (int j = 0; j < TPW; ++j) {
        const int pp = y * PW + ln.poff[j];
        uint32_t b[NT8][2];
        if constexpr (NT8 == 1) {  // one n-tile: lanes 0-15 give the rows
          tc::ldsm_x2_trans(yt + ln.pbase[j] + 16u * tc::chunk_at<NCY>(pp, 0),
                            b[0]);
        } else {
#pragma unroll
          for (int np = 0; np < NT8 / 2; ++np) {
            uint32_t r[4];
            tc::ldsm_x4_trans(
                yt + ln.pbase[j] +
                    16u * tc::chunk_at<NCY>(pp, 2 * np + ln.bchunk),
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
          for (int t = 0; t < NT8; ++t)
            tc::mma(acc[j][m][t], a[m], b[t][0], b[t][1]);
      }
    }
  }

  // The block's dW share (this warp's taps) into row[T] in the (4, 4, ci,
  // co) layout: C fragment (j, m, t) holds rows (ci) 16 m + gq (+ 8) and
  // columns (co) 8 t + 2 q4, + 1 of tap 2 warp + j; the padded rows and
  // columns are not stored.
  static __device__ __forceinline__ void store(const Acc& acc, float* row,
                                               int warp, int lane) {
    const int gq = lane >> 2, q4 = lane & 3;
#pragma unroll
    for (int j = 0; j < TPW; ++j)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT8; ++t)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int ci = 16 * m + gq + 8 * h, co = 8 * t + 2 * q4;
            if ((CIP == CI || ci < CI) && (NT8 * 8 == CO || co < CO))
              *reinterpret_cast<float2*>(
                  row + ((warp * TPW + j) * CI + ci) * CO + co) =
                  make_float2(acc[j][m][t][2 * h], acc[j][m][t][2 * h + 1]);
          }
  }
};

}  // namespace pt
