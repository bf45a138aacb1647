// K6 conv_dw — weight gradient of the stride-1, odd k x k 'same'
// convolution:
//   dw[kh, kw, ci, co] = sum over b, h, w of
//                        x[b, h + kh - r, w + kw - r, ci] * dy[b, h, w, co]
// with zero padding, bf16 x and dy in, f32 accumulation, f32 out in the
// (k, k, ci, co) layout.
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:pallas_conv_dw (_dw_kernel,
// halo_weights_adjoint), which accumulates dW in VMEM across its
// sequential grid.
//
// Bound on the H100, per regime:
// - 1x1: bytes. ci*co MACs a pixel against 2*(ci + co) bytes read (128 at
//   (32, 16)): a GEMM with a very long K and nothing to reuse, so the
//   time is the bytes in flight and how evenly the SMs draw them (each
//   SM tops out near a 132nd of the card's rate).
// - 3x3: near the ridge (9*ci*co MACs a pixel: 288 operations a byte at
//   (64, 64), 144 at (32, 32)): the tensor cores' issue rate, and the
//   shared-memory reads that feed them.
// - 7x7: operations at co 16 (49*16*16 MACs a pixel); bytes at the
//   classifier's co 3 or 4, whose N pads to 8.
//
// Design:
// - A persistent grid of clusters walks tiles t = blockIdx.x + i *
//   gridDim.x; a tile is TH rows of 16 pixels (one row is one k-step): at
//   1x1 a run of TH*16 consecutive NHWC pixels (no halo, ragged only at
//   the end of the batch), else a 16 x 16 block of one image with its x
//   halo.
// - The tiles arrive by 16-byte cp.async (8-byte where a pixel holds 8
//   bytes; at co = 3, 6-byte pixels, by loads into registers issued a
//   slot ahead and stored after the tile's GEMM) into a ring of 3 or 4
//   stages: STAGES - 1 tiles in flight while one is computed, one
//   barrier a tile. Chunks are swizzled (tensor_core.cuh:chunk_at), so
//   any 8 consecutive pixels hit 8 bank groups.
// - GEMM per tile: dW += A · B, A = x (M = channels, K = pixels), B = dy
//   (N = co), from the pixel-major tiles. A warp owns one tap column kw
//   and walks its x rows once: the A fragment of x row r at column
//   offset kw (ldmatrix.trans) feeds the taps (kh, kw) of the k dy rows
//   r - kh, so A is read once a row and tap column, not once a tap.
//   - mma.sync m16n8k16 (1x1, 3x3 up to ci 32, the classifiers): a warp
//     owns MC channel tiles and WN n-tiles; B by ldmatrix.trans, each dy
//     row's fragments live in registers for the k rows that use them.
//     Accumulators K*MC*WN*4 (at most 96) a lane, sized with the warps
//     and blocks an SM holds (__launch_bounds__ from that estimate), so
//     no shape spills; small dW is split over G row groups (sub-tiles
//     with their own sums, added in group order).
//   - wgmma (wgmma.cuh; the 3x3s at ci 64, the 7x7s at co 16): the
//     warps of a warpgroup take 4 (tap column, 16-channel) M units, A
//     from their registers; one asynchronous m64 product an x row, N =
//     co columns for each tap row whose dy row is in the tile, B read
//     straight from the dy tile by descriptor (chunk_at's swizzle is the
//     hardware's 32/64/128-byte swizzle; the tap rows are atoms along N,
//     one dy row apart).
//   - co <= 4 (the classifiers, (8, 4, 3)): a tile row of the dy tile
//     holds dy row y in columns 0-3 and row y - 1 in columns 4-7, so one
//     n-tile serves two tap rows: ceil(k/2) MMAs an x row, not k.
// - Across blocks, no atomics on dW: each block puts its share in its
//   shared memory; the two blocks of a cluster add the shares in rank
//   order through distributed shared memory, each rank half of dW, into
//   the pair's row of the scratch tensor, and sum_rows (partials.cuh)
//   adds the rows in its fixed order across the card (a second, short
//   launch: summing them in the last cluster to finish, in the same
//   launch, left a serial tail longer than it). Pairs, not clusters of
//   8: whole clusters must fit a GPC, and 8 leave about 1 SM in 11 idle.
//   The grid is fixed per instance and device, so dW is the same bits on
//   every run.
// - 8-channel streams (ci = 8): the x tile is zero-padded to 16 channels
//   (tc::pad16); their sums are never written.
#include <cooperative_groups.h>

#include "partials.cuh"
#include "tensor_core.cuh"
#include "wgmma.cuh"
#include "ubr_shapes.h"  // UBR_CONV_DW_SHAPES (ops/_build.py:SHAPES)

namespace coop = cooperative_groups;

namespace {

constexpr int TW = 16;                 // pixels a tile row (a k-step)
// blocks a cluster: pairs halve the scratch rows; clusters of 8 would
// quarter them again but leave about 1 SM in 11 idle (whole clusters
// must fit a GPC), which costs more than the rows at every instance
constexpr int CLUSTER = 2;
constexpr int SMEM_TWO = 115000;       // a block's share at 2 blocks an SM
constexpr int SMEM_ONE = 225 * 1024;   // at 1 block an SM

constexpr int pow2_upto(int n, int cap) {  // largest 2^j <= min(n, cap)
  int d = 1;
  while (2 * d <= n && 2 * d <= cap) d *= 2;
  return d;
}
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
// A warp's share of a tile's GEMM, at most f accumulator fragments
// (k tap rows x mc channel tiles x wn n-tiles): wn n-tiles (of nt8),
// then mc channel tiles (of nmc)
constexpr int wn_of(int k, int nt8, int f) {
  return pow2_upto(nt8, imin(4, f / k));
}
constexpr int mc_of(int k, int nmc, int nt8, int f) {
  return pow2_upto(nmc, imin(4, imax(1, f / (k * wn_of(k, nt8, f)))));
}
// warps that cover one tile row window: one a (kw, channel group, n group)
constexpr int warps_of(int k, int nmc, int nt8, int f) {
  return k * (nmc / mc_of(k, nmc, nt8, f)) * (nt8 / wn_of(k, nt8, f));
}
// fragments a warp: 12 (48 registers), 24 at 7x7 (two n-tiles of all 7
// tap rows) and where 12 would take more than 12 warps
constexpr int frags_of(int k, int nmc, int nt8) {
  return k >= 7 || warps_of(k, nmc, nt8, 12) > 12 ? 24 : 12;
}
// B descriptor of an MN-major K x N tile, K = 16 pixel rows of COP bf16
// each (chunk_at's swizzle of 8-, 4- and 2-chunk pixels is the 128-, 64-
// and 32-byte swizzle: 16-byte unit XOR bits 7-9 of the offset), N =
// slots of COP columns (atoms along N, LBO = STRIDE bytes apart; 8-row
// groups SBO = 16 COP bytes apart)
template <int COP, int STRIDE>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  static_assert(COP == 16 || COP == 32 || COP == 64, "a swizzled row");
  constexpr uint64_t swz = COP == 64 ? 1 : COP == 32 ? 2 : 3;
  return ((addr & 0x3FFFFu) >> 4) | ((uint64_t)(STRIDE >> 4) << 16) |
         ((uint64_t)(COP) << 32) | (swz << 62);
}
// cnt (1 .. KS) slots of COP columns: d += a · B, B at descriptor b
template <int COP, int KS>
__device__ __forceinline__ void wgmma_slots(int cnt, float* d,
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (KS >= 1) if (cnt == 1) wg::mma<COP>(d, a, b);
  if constexpr (KS >= 2) if (cnt == 2) wg::mma<2 * COP>(d, a, b);
  if constexpr (KS >= 3) if (cnt == 3) wg::mma<3 * COP>(d, a, b);
  if constexpr (KS >= 4) if (cnt == 4) wg::mma<4 * COP>(d, a, b);
  if constexpr (KS >= 5) if (cnt == 5) wg::mma<5 * COP>(d, a, b);
  if constexpr (KS >= 6) if (cnt == 6) wg::mma<6 * COP>(d, a, b);
  if constexpr (KS >= 7) if (cnt == 7) wg::mma<7 * COP>(d, a, b);
}

template <int CI, int CO, int K>
struct DwShape {
  static constexpr int CIP = tc::pad16(CI);        // channels of x's tile
  static constexpr int NCX = CIP / 8;               // x chunks a pixel
  static constexpr int COP = (CO + 7) / 8 * 8;      // padded N
  static constexpr int NCD = COP / 8;               // dy chunks a pixel
  static constexpr int NMC = CIP / 16, NT8 = COP / 8;
  // wgmma where the M units (tap column, 16-channel tile) fill 64-row
  // warpgroups (one idle warp in 8 at 7x7): the 3x3s at ci 64 and the
  // 7x7s at co 16 (N: co columns for each tap row of an x row)
  static constexpr int MU = K * NMC;
  static constexpr bool WGMMA = (K == 7 && CO > 4) || (K == 3 && NMC >= 4);
  static constexpr int F = frags_of(K, NMC, NT8);
  static constexpr int WN = WGMMA ? NT8 : wn_of(K, NT8, F);
  static constexpr int MC = WGMMA ? 1 : mc_of(K, NMC, NT8, F);
  static constexpr int WPG =  // warps a group
      WGMMA ? 4 * ((MU + 3) / 4) : warps_of(K, NMC, NT8, F);
  // row groups: enough to give a block 6 to 8 warps
  static constexpr int G =
      WGMMA || WPG >= 6 ? 1 : WPG >= 3 ? 2 : WPG >= 2 ? 4 : 8;
  static constexpr int NT = 32 * WPG * G;
  static constexpr int TH = 16;                     // tile rows
  static constexpr int RG = TH / G;                 // dy rows a group
  static constexpr int XR = RG + K - 1;             // x rows a group reads
  // co <= 4 (the classifiers, (8, 4, 3)): two tap rows an n-tile. A
  // group's dy tile row y holds dy row y in columns 0-3 and dy row y - 1
  // in columns 4-7 (zero outside the group's rows), so B of row r - 2m
  // feeds taps 2m and 2m + 1 at once: ceil(k/2) MMAs an x row, not k
  static constexpr bool PAIR = K > 1 && CO <= 4;
  static constexpr int KS = PAIR ? (K + 1) / 2 : K;  // tap-row slots
  static constexpr int DR = PAIR ? RG + 1 : RG;     // dy tile rows a group
  // 1x1: a tile is a run of TP consecutive pixels, else an image block
  static constexpr bool FLAT = K == 1;
  static constexpr int XH = TH + K - 1, XW = TW + K - 1;  // x tile
  static constexpr int TP = TH * TW;                // pixels a tile
  static constexpr int X_ELEMS = XH * XW * CIP, D_ELEMS = G * DR * TW * COP;
  // wgmma's B tiles start on 1024-byte boundaries (the swizzle's period)
  static constexpr int ALIGN = WGMMA ? 512 : 8;    // bf16
  static constexpr int X_PAD = (X_ELEMS + ALIGN - 1) / ALIGN * ALIGN;
  static constexpr int STAGE_E = (X_PAD + D_ELEMS + ALIGN - 1) / ALIGN * ALIGN;
  static constexpr int STAGE = 2 * STAGE_E;
  static constexpr int T = K * K * CI * CO;         // dW elements
  static constexpr int SHARE = 4 * T;
  // ring stages: 4 (or 3) where two blocks an SM still fit, else as many
  // as fit one block (at most 4)
  static constexpr int STAGES =
      SHARE <= SMEM_TWO && 4 * STAGE <= SMEM_TWO   ? 4
      : SHARE <= SMEM_TWO && 3 * STAGE <= SMEM_TWO ? 3
                                                   : imin(4, SMEM_ONE / STAGE);
  static constexpr int SMEM =
      imax(STAGES * STAGE + (WGMMA ? 1024 : 0), SHARE);
  // registers a lane: accumulators, the live B rows, two A rows, the rest
  static constexpr int REG =
      KS * MC * WN * 4 + (K + 1) * WN * 2 + 2 * MC * 4 + 24;
  static constexpr int MINB =
      imax(1, imin(imin(tc::blocks_per_sm<SMEM, 4>(), 65536 / (NT * REG)), 4));
  static constexpr int DPT = (TP + NT - 1) / NT;    // co = 3: pixels a thread
  static_assert(CI % 8 == 0, "ci: whole 16-byte chunks");
  static_assert(STAGES >= 2 && SMEM <= tc::SMEM_MAX, "the ring fits");
  static_assert(TH % G == 0 && NT <= 1024, "rows split over the groups");
  static_assert(T % 4 == 0 && STAGE % 16 == 0, "float4 shares, 16-byte tiles");
  static_assert(!WGMMA || (G == 1 && MC == 1 && !PAIR),
                "wgmma: one group, one channel tile, whole tap rows");
};

template <int CI, int CO, int K>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(
    DwShape<CI, CO, K>::NT, DwShape<CI, CO, K>::MINB)
conv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               float* __restrict__ part, int B, int H, int W) {
  using S = DwShape<CI, CO, K>;
  constexpr int MC = S::MC, WN = S::WN, NT = S::NT, RG = S::RG, DR = S::DR;
  extern __shared__ uint4 smem[];
  bf16* ring = reinterpret_cast<bf16*>(  // S stages of x, dy tiles
      S::WGMMA ? (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023)
               : reinterpret_cast<uintptr_t>(smem));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / S::WPG, u = warp % S::WPG;
  // wgmma's idle warps (u >= MU) repeat unit 0; their sums are dropped
  const bool live = !S::WGMMA || u < S::MU;
  const int uu = live ? u : 0;
  const int kw = uu % K, mcg = (uu / K) % (S::NMC / MC);
  const int ng = uu / K / (S::NMC / MC);
  const int gq = lane >> 2, q4 = lane & 3, mi = lane >> 3, r8 = lane & 7;
  const long npix = (long)B * H * W;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + S::TH - 1) / S::TH;
  const int per_img = tiles_x * tiles_y;
  const int ntiles = S::FLAT ? (int)((npix + S::TP - 1) / S::TP) : B * per_img;

  // ---- loads: x (haloed unless 1x1) and dy of tile t into stage st
  auto load_x = [&](int t, int st) {
    bf16* xd = ring + st * S::STAGE_E;
    if constexpr (S::FLAT) {
      const long p0 = (long)t * S::TP;
      for (int e = tid; e < S::TP * S::NCX; e += NT) {
        const int p = e / S::NCX, c = e % S::NCX;
        const bool in = p0 + p < npix;
        tc::cp_chunk<CI * 2>(tc::smem_u32(xd + tc::chunk_at<S::NCX>(p, c) * 8),
                             x, in ? x + (p0 + p) * CI : x, c, in);
      }
    } else {
      const int n = t / per_img, rr = t % per_img;
      const int ih0 = (rr / tiles_x) * S::TH - K / 2;
      const int iw0 = (rr % tiles_x) * TW - K / 2;
      for (int e = tid; e < S::XH * S::XW * S::NCX; e += NT) {
        const int p = e / S::NCX, c = e % S::NCX;
        const int ih = ih0 + p / S::XW, iw = iw0 + p % S::XW;
        const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
        const bf16* src = in ? x + (((long)n * H + ih) * W + iw) * CI : x;
        tc::cp_chunk<CI * 2>(tc::smem_u32(xd + tc::chunk_at<S::NCX>(p, c) * 8),
                             x, src, c, in);
      }
    }
  };
  // dy pixel p of tile t: its index in dy, or -1 outside the image
  auto dy_pix = [&](int t, int p) -> long {
    if constexpr (S::FLAT) {
      const long q = (long)t * S::TP + p;
      return q < npix ? q : -1;
    } else {
      const int n = t / per_img, rr = t % per_img;
      const int oh = (rr / tiles_x) * S::TH + p / TW;
      const int ow = (rr % tiles_x) * TW + p % TW;
      return oh < H && ow < W ? ((long)n * H + oh) * W + ow : -1;
    }
  };
  auto dy_tile = [&](int st) {
    return ring + st * S::STAGE_E + S::X_PAD;
  };
  // dy tile row of tile pixel p (its group's rows start at g DR)
  auto dy_row = [&](int p) { return (p / TW / RG) * DR + (p / TW) % RG; };
  auto load_dy = [&](int t, int st) {  // co a multiple of 4
    if constexpr (S::PAIR && CO == 4) {  // 8-byte pixels, each in 2 rows
      bf16* dd = dy_tile(st);
      for (int p = tid; p < S::TP; p += NT) {
        const long q = dy_pix(t, p);
        const uint32_t d = tc::smem_u32(dd + (dy_row(p) * TW + p % TW) * 8);
        const bf16* src = q >= 0 ? dy + q * CO : dy;
        tc::cp_async8(d, src, q >= 0);            // row y, columns 0-3
        tc::cp_async8(d + 16 * TW + 8, src, q >= 0);  // row y + 1, 4-7
      }
    } else if constexpr (CO % 4 == 0) {
      bf16* dd = dy_tile(st);
      for (int e = tid; e < S::TP * S::NCD; e += NT) {
        const int p = e / S::NCD, c = e % S::NCD;
        const long q = dy_pix(t, p);
        tc::cp_chunk<CO * 2>(
            tc::smem_u32(dd + tc::chunk_at<S::NCD>(p, c) * 8), dy,
            q >= 0 ? dy + q * CO : dy, c, q >= 0);
      }
    }
  };
  // co = 3: 6-byte pixels, which no cp.async copies; loaded into
  // registers (fetch) a slot ahead and stored zero-padded to 8 (put)
  uint32_t d3[S::DPT][2];
  auto fetch_dy3 = [&](int t) {
#pragma unroll
    for (int j = 0; j < S::DPT; ++j) {
      const int p = tid + j * NT;
      const long q = p < S::TP ? dy_pix(t, p) : -1;
      const unsigned short* s =
          reinterpret_cast<const unsigned short*>(dy) + (q >= 0 ? q * CO : 0);
      d3[j][0] =
          q >= 0 ? (uint32_t)__ldg(s) | ((uint32_t)__ldg(s + 1) << 16) : 0u;
      d3[j][1] = q >= 0 ? (uint32_t)__ldg(s + 2) : 0u;
    }
  };
  auto put_dy3 = [&](int st) {
    bf16* dd = dy_tile(st);
#pragma unroll
    for (int j = 0; j < S::DPT; ++j) {
      const int p = tid + j * NT;
      if (p < S::TP) {
        bf16* d = dd + (dy_row(p) * TW + p % TW) * 8;
        if constexpr (S::PAIR) {
          *reinterpret_cast<uint2*>(d) = make_uint2(d3[j][0], d3[j][1]);
          *reinterpret_cast<uint2*>(d + TW * 8 + 4) =
              make_uint2(d3[j][0], d3[j][1]);
        } else {
          *reinterpret_cast<uint4*>(d) =
              make_uint4(d3[j][0], d3[j][1], 0u, 0u);
        }
      }
    }
  };
  // the pair tiles' fixed zeros: columns 0-3 of a group's last row,
  // 4-7 of its first, in every stage
  if constexpr (S::PAIR) {
    for (int e = tid; e < S::STAGES * S::G * TW; e += NT) {
      bf16* dd = dy_tile(e / (S::G * TW));
      const int g = e / TW % S::G, x = e % TW;
      *reinterpret_cast<uint2*>(dd + ((g * DR + RG) * TW + x) * 8) =
          make_uint2(0u, 0u);
      *reinterpret_cast<uint2*>(dd + (g * DR * TW + x) * 8 + 4) =
          make_uint2(0u, 0u);
    }
  }

  // ---- this warp's fragments: A rows (matrix mi: pixels 8 (mi >> 1) ..,
  // channel chunk mi & 1 of a 16-channel tile), B rows (matrix mi: pixels
  // 8 (mi & 1) .., n-tile mi >> 1 of a pair)
  const int apix = kw + r8 + 8 * (mi >> 1), achunk = 2 * mcg * MC + (mi & 1);
  const int bpix = r8 + 8 * (mi & 1), bchunk = ng * WN + (mi >> 1);
  const int xr0 = grp * RG;  // the group's first row (x and dy)

  float acc[S::KS][MC][WN][4];
#pragma unroll
  for (int a = 0; a < S::KS; ++a)
#pragma unroll
    for (int m = 0; m < MC; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[a][m][n][i] = 0.f;

  auto gemm = [&](int st) {
    const uint32_t xt = tc::smem_u32(ring + st * S::STAGE_E);
    const uint32_t dt = xt + 2u * S::X_PAD;
    uint32_t a[2][MC][4];
    uint32_t b[DR][WN][2];
    auto load_a = [&](int r, uint32_t (&f)[MC][4]) {
      const int p = (xr0 + r) * S::XW + apix;
#pragma unroll
      for (int m = 0; m < MC; ++m)
        tc::ldsm_x4_trans(xt + 16u * tc::chunk_at<S::NCX>(p, achunk + 2 * m),
                          f[m]);
    };
    auto load_b = [&](int y, uint32_t (&f)[WN][2]) {
      const int p = (grp * DR + y) * TW + bpix;
      if constexpr (WN == 1) {
        tc::ldsm_x2_trans(dt + 16u * tc::chunk_at<S::NCD>(p, ng), f[0]);
      } else {
#pragma unroll
        for (int np = 0; np < WN / 2; ++np) {
          uint32_t v[4];
          tc::ldsm_x4_trans(dt + 16u * tc::chunk_at<S::NCD>(p, bchunk + 2 * np),
                            v);
          f[2 * np][0] = v[0];
          f[2 * np][1] = v[1];
          f[2 * np + 1][0] = v[2];
          f[2 * np + 1][1] = v[3];
        }
      }
    };
    if constexpr (S::WGMMA) {
      // A of x row r in aw[r % 3]: row r + 1 is loaded while row r's
      // products run, into the registers that row r - 2's have released.
      // One product a row: N = the tap rows kh whose dy row r - kh lies
      // in the tile, in the order of their rows (slot a = K - 1 - kh),
      // each COP columns and one dy row after the last
      constexpr int NA = 3;  // A buffers: NA - 2 rows' products in flight
      uint32_t aw[NA][4];
      const uint32_t db = dt + 2u * grp * DR * TW * S::COP;
      auto load_aw = [&](int r, uint32_t (&f)[4]) {
        const int p = (xr0 + r) * S::XW + apix;
        tc::ldsm_x4_trans(xt + 16u * tc::chunk_at<S::NCX>(p, achunk), f);
      };
      load_aw(0, aw[0]);
#pragma unroll
      for (int r = 0; r < S::XR; ++r) {
        if (r + 1 < S::XR) {
          if (r >= NA - 1) wg::wait<NA - 2>();
          load_aw(r + 1, aw[(r + 1) % NA]);
        }
        const int khi = imin(K - 1, r), klo = imax(0, r - DR + 1);
        wg::fence();
        wgmma_slots<S::COP, K>(
            khi - klo + 1, &acc[K - 1 - khi][0][0][0], aw[r % NA],
            b_desc<S::COP, 2 * TW * S::COP>(db + 2u * (r - khi) * TW * S::COP));
        wg::commit();
      }
      wg::wait<0>();  // the stage's tiles are read; acc is final
#pragma unroll
      for (int kh = 0; kh < S::KS; ++kh)
#pragma unroll
        for (int n = 0; n < WN; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) wg::fence_operand(acc[kh][0][n][i]);
      return;
    }
    load_a(0, a[0]);
    load_b(0, b[0]);
#pragma unroll
    for (int r = 0; r < S::XR; ++r) {  // x row r feeds dy rows r - kh
      if (r + 1 < S::XR) load_a(r + 1, a[(r + 1) & 1]);
      if (r + 1 < DR) load_b(r + 1, b[r + 1]);
#pragma unroll
      for (int kh = 0; kh < S::KS; ++kh) {  // tap row (pair) slot
        const int y = r - (S::PAIR ? 2 * kh : kh);
        if (y >= 0 && y < DR) {
#pragma unroll
          for (int m = 0; m < MC; ++m)
#pragma unroll
            for (int n = 0; n < WN; ++n)
              tc::mma(acc[kh][m][n], a[r & 1][m], b[y][n][0], b[y][n][1]);
        }
      }
    }
  };

  // ---- the walk: S - 1 tiles in flight, one barrier a tile
  const int t0 = blockIdx.x, step = gridDim.x;
#pragma unroll 1
  for (int s = 0; s < S::STAGES - 1; ++s) {
    const int t = t0 + s * step;
    if (t < ntiles) {
      load_x(t, s);
      if constexpr (CO % 4 == 0) {
        load_dy(t, s);
      } else {
        fetch_dy3(t);
        put_dy3(s);
      }
    }
    tc::cp_async_commit();
  }
#pragma unroll 1
  for (int i = 0, t = t0; t < ntiles; ++i, t += step) {
    tc::cp_async_wait_group<S::STAGES - 2>();
    if constexpr (S::WGMMA) wg::fence_proxy_async();  // wgmma reads dy there
    __syncthreads();  // tile t landed; the stage loaded below is free
    const int tn = t + (S::STAGES - 1) * step;
    const int sn = (i + S::STAGES - 1) % S::STAGES;
    if (tn < ntiles) {
      load_x(tn, sn);
      if constexpr (CO % 4 == 0)
        load_dy(tn, sn);
      else
        fetch_dy3(tn);
    }
    tc::cp_async_commit();
    gemm(i % S::STAGES);
    if constexpr (CO % 4 != 0)
      if (tn < ntiles) put_dy3(sn);
  }

  // ---- this block's dW into its shared memory: fragment (a, m, n, i)
  // is channel (mcg MC + m) 16 + gq + 8 (i >> 1) of tap (a, kw), column
  // (ng WN + n) 8 + 2 q4 + (i & 1) (paired: tap (2a + column / 4, kw),
  // column % 4); padded channels and columns have no element
  float* share = reinterpret_cast<float*>(smem);
  auto each = [&](auto&& f) {
#pragma unroll
    for (int a = 0; a < S::KS; ++a)
#pragma unroll
      for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int n = 0; n < WN; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int ch = (mcg * MC + m) * 16 + gq + 8 * (i >> 1);
            // wgmma: slot a holds tap row K - 1 - a
            const int sl = S::WGMMA ? S::KS - 1 - a : a;
            int c = (ng * WN + n) * 8 + 2 * q4 + (i & 1), kh = sl;
            if constexpr (S::PAIR) {
              kh = 2 * sl + c / 4;
              c %= 4;
            }
            if (live && (S::CIP == CI || ch < CI) &&
                (S::COP == CO || c < CO) && kh < K)
              f(((kh * K + kw) * CI + ch) * CO + c, acc[a][m][n][i]);
          }
  };
  tc::cp_async_wait_all();
  __syncthreads();  // the ring is drained and read: it takes the share
#pragma unroll 1
  for (int g = 0; g < S::G; ++g) {  // row groups in order
    if (grp == g) {
      if (g == 0)
        each([&](int e, float v) { share[e] = v; });
      else
        each([&](int e, float v) { share[e] += v; });
    }
    __syncthreads();
  }

  // ---- the cluster's shares, rank by rank, into its scratch row
  coop::cluster_group cluster = coop::this_cluster();
  cluster.sync();  // every rank's share is in place
  constexpr int CL = CLUSTER, T4 = S::T / 4, U = (T4 + CL - 1) / CL;
  const int rank = (int)cluster.block_rank();
  const int u0 = rank * U, u1 = imin(u0 + U, T4);
  float4* row = reinterpret_cast<float4*>(part) + (long)(blockIdx.x / CL) * T4;
  const float4* sh = reinterpret_cast<const float4*>(share);
  for (int e = u0 + tid; e < u1; e += NT) {
    float4 s = *cluster.map_shared_rank(sh + e, 0);
#pragma unroll
    for (int q = 1; q < CL; ++q) {
      const float4 v = *cluster.map_shared_rank(sh + e, q);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    row[e] = s;
  }
  cluster.sync();  // no rank reads another's share any more
}

// The clusters of an instance that fit on the card at once, the most its
// persistent grid takes: asked once per instance (the kernel's
// shared-memory limit raised first).
template <int CI, int CO, int K>
cudaError_t resident_clusters(int* clusters) {
  using S = DwShape<CI, CO, K>;
  static int most = 0;
  cudaError_t e = cudaSuccess;
  if (most == 0)  // raised even at 48 KB: the static bytes count too
    e = cudaFuncSetAttribute(conv_dw_kernel<CI, CO, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::SMEM);
  if (e == cudaSuccess && most == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(S::NT);
    cfg.dynamicSmemBytes = S::SMEM;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(
        &n, (const void*)conv_dw_kernel<CI, CO, K>, &cfg);
    if (e == cudaSuccess && n < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) most = n;
  }
  *clusters = most;
  return e;
}

template <int CI, int CO, int K>
long tiles_of(int B, int H, int W) {
  using S = DwShape<CI, CO, K>;
  if (S::FLAT) return ((long)B * H * W + S::TP - 1) / S::TP;
  return (long)B * ((H + S::TH - 1) / S::TH) * ((W + TW - 1) / TW);
}

// [the most clusters, ring stages, pixels a tile, tiles, clusters a
// launch takes at most rows scratch rows, blocks a cluster]
template <int CI, int CO, int K>
int grid_of(int* out, int B, int H, int W, int rows) {
  using S = DwShape<CI, CO, K>;
  int most = 0;
  cudaError_t e = resident_clusters<CI, CO, K>(&most);
  if (e != cudaSuccess) return (int)e;
  const long tiles = tiles_of<CI, CO, K>(B, H, W);
  long clusters = (tiles + CLUSTER - 1) / CLUSTER;
  if (clusters > most) clusters = most;
  if (clusters > rows) clusters = rows;
  out[0] = most;
  out[1] = S::STAGES;
  out[2] = S::TP;
  out[3] = (int)tiles;
  out[4] = (int)clusters;
  out[5] = CLUSTER;
  return 0;
}

template <int CI, int CO, int K>
int launch(const void* x, const void* dy, void* part, void* dw, int B, int H,
           int W, int rows, cudaStream_t stream) {
  using S = DwShape<CI, CO, K>;
  int g[6];
  const int e = grid_of<CI, CO, K>(g, B, H, W, rows);
  if (e != 0) return e;
  if (g[3] == 0)  // no pixels: dW is zero
    return (int)cudaMemsetAsync(dw, 0, S::T * sizeof(float), stream);
  conv_dw_kernel<CI, CO, K><<<g[4] * CLUSTER, S::NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<float*>(part), B, H, W);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return (int)e2;
  return (int)sum_rows(static_cast<const float*>(part), g[4], S::T, 1.f,
                       static_cast<float*>(dw), stream);
}

}  // namespace

// (ci, co, k) instantiated: UBR_CONV_DW_SHAPES, from the one table in
// ops/_build.py:SHAPES. x and dy must be 16-byte aligned. part is the
// wrapper's (rows, k*k*ci*co) f32 scratch: the kernel runs min(rows,
// resident clusters, clusters with tiles) clusters, each writing one
// row, and sum_rows adds that many rows into dw, (k, k, ci, co) f32.
UBR_EXPORT int ubr_conv_dw(const void* x, const void* dy, void* part,
                           void* dw, int B, int H, int W, int ci, int co,
                           int k, int rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1) return (int)cudaErrorInvalidValue;
#define UBR_DW(CI, CO, K)                                                  \
  if (ci == CI && co == CO && k == K)                                      \
    return launch<CI, CO, K>(x, dy, part, dw, B, H, W, rows, s);
  UBR_CONV_DW_SHAPES(UBR_DW)
#undef UBR_DW
  return (int)cudaErrorInvalidValue;
}

// The launch geometry of an instance on the current device, into out[6]:
// the most clusters that fit at once, the ring's stages, the pixels of a
// tile, the tiles of a (B, H, W) batch, the clusters a launch with rows
// scratch rows takes, and the blocks of a cluster.
UBR_EXPORT int ubr_conv_dw_grid(int* out, int B, int H, int W, int ci,
                                int co, int k, int rows) {
#define UBR_DW(CI, CO, K)                                                  \
  if (ci == CI && co == CO && k == K)                                      \
    return grid_of<CI, CO, K>(out, B, H, W, rows);
  UBR_CONV_DW_SHAPES(UBR_DW)
#undef UBR_DW
  return (int)cudaErrorInvalidValue;
}
