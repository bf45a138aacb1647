// K8 conv_s2k4 — input gradient of ConvTranspose2d(k=4, stride=2,
// padding=1): the stride-2, k4, pad-1 cross-correlation
//   dx[b, i, j, ci] = sum over kr, kc, co of
//                     w[kr, kc, ci, co] * dy[b, 2i + kr - 1, 2j + kc - 1, co]
// with zeros outside dy, NHWC bf16 dy (B, 2H, 2W, co), the deconv's own
// kernel w (4, 4, ci, co) bf16 (no transpose, no flip), f32 accumulation,
// bf16 dx (B, H, W, ci).
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:fused_conv_s2k4 (_s2k4_kernel,
// s2k4_weights, _S2_TAPS), the dx leg of pallas_deconv2x_ad. The TPU
// form's W-packing, halo combos and lane packing exist to fill the MXU's
// lanes and are not carried over.
//
// Bound on the H100: bytes (16 taps x ci x co MACs per dx pixel against
// its 4 dy pixels read and 1 dx pixel written: 128 operations per byte
// at dec2, 64 at dec1, below the ~295 op/B bf16 tensor-core ridge).
//
// Design (tensor cores): an implicit GEMM on bf16 mma.sync m16n8k16
// with f32 accumulators,
//   M = the tile's dx pixels, 16 per M-tile (one dx row),
//   N = ci (8 n-tiles at dec2, 4 at dec1),
//   K = 16 taps x co, tap-major (2 k-steps a tap at co = 32, 1 at 16),
// B[tap co + c, n] = w[tap, n, c] laid out once per block as per-lane
// fragments (tc::stage_b8).
// - Parity planes. Read naively, tap (kr, kc)'s A rows are dy pixels at
//   stride 2 (2j + kc), and the chunk swizzle (tensor_core.cuh:chunk_at)
//   spreads 8 CONSECUTIVE pixels over the bank groups, not 8 at stride
//   2. So the haloed dy tile (rows 2i0 - 1 .. 2i0 + 2QH, columns
//   2j0 - 1 .. 2j0 + 2QW) lands as its four (row parity, column parity)
//   planes, each a (QH + 1) x (QW + 1) pixel array swizzled on its own:
//   tap (kr, kc) reads plane (kr & 1, kc & 1) at offset (kr >> 1,
//   kc >> 1), 16 consecutive pixels per M-tile row, the access pattern of
//   K1's conv_rows, conflict-free for ldmatrix.
// - A persistent grid (SMs x blocks per SM, asked once per kernel
//   instance) walks dx tiles t = blockIdx.x + i * gridDim.x; the next
//   tile's planes arrive by double-buffered 16-byte cp.async, zero-filled
//   outside dy (src-size 0), while this one is computed.
// - 8 warps, J dx rows (M-tiles) each; the epilogue rounds to bf16 and
//   stages the warp's rows for 16-byte coalesced stores.
// Shared memory bounds the tile at dec2: B is 32 k-steps x 8 n-tiles x 32
// lanes x 8 B = 64 KB and a 16x16 dx tile's planes 74 KB, so two buffers
// would not fit beside B and the staging. dec2 takes 8x16 dx tiles (J = 1:
// 38 KB of planes a buffer, 157 KB in all, one block per SM), dec1 16x16
// (J = 2: B 16 KB, planes 36 KB a buffer, 104 KB, two blocks per SM).
//
// 8-channel streams (dec1 (16, 8) at inplanes 8; dec2 (16, 8) and dec1
// (8, 4) at 4, under fused_train_deconv): the dy planes are zero-padded
// to one 16-channel k-step a tap (tc::pad16; co = 8 copies one chunk a
// pixel and zero-fills the second, co = 4 half of one, tc::cp_chunk),
// with zero B rows past co; N = ci = 8 is one n-tile. 2x (co 8) and 4x
// (co 4) the real MACs, still bound by bytes.
#include "conv_gemm.cuh"  // zero_acc
#include "ubr_shapes.h"  // UBR_CONV_S2K4_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int NWARP = 8, NT = 32 * NWARP;
constexpr int QW = 16;  // dx columns of a tile: one M-tile a row

template <int CI, int CO>
struct S2k4Shape {
  static constexpr int J = CO >= 32 ? 1 : 2;       // dx rows a warp
  static constexpr int QH = NWARP * J;             // dx rows of a tile
  static constexpr int PH = QH + 1, PW = QW + 1;   // a plane's pixels
  static constexpr int YH = 2 * PH, YW = 2 * PW;   // the haloed dy tile
  static constexpr int COP = tc::pad16(CO);       // channels of a plane
  static constexpr int NC = COP / 8;               // dy chunks a pixel
  static constexpr int KC = COP / 16;              // k-steps a tap
  static constexpr int KSTEPS = 16 * KC;
  static constexpr int NT8 = CI / 8, NCI = CI / 8;  // n-tiles; dx chunks
  static constexpr int B_UNITS = KSTEPS * NT8 * 32;  // uint2 of B fragments
  static constexpr int PLANE = PH * PW * COP;        // bf16 of a plane
  static constexpr int Y_ELEMS = 4 * PLANE;          // bf16 of a buffer
  static constexpr int ST = J * QW * CI;             // staging bf16 a warp
  static constexpr int SMEM = B_UNITS * 8 + (2 * Y_ELEMS + NWARP * ST) * 2;
  static_assert(CI % 8 == 0 && CO % 4 == 0,
                "dx in n-tiles of 8; dy pixels of whole 8-byte units");
  // the k-step XOR (bit 5 of a byte offset) must not reach the plane base
  static_assert(KC == 1 || PLANE * 2 % 64 == 0, "plane base alignment");
};

template <int CI, int CO>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<S2k4Shape<CI, CO>::SMEM, 2>()))
conv_s2k4_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                 bf16* __restrict__ dx, int B, int H, int W) {
  using S = S2k4Shape<CI, CO>;
  constexpr int J = S::J, NT8 = S::NT8, NC = S::NC, NCI = S::NCI;
  extern __shared__ uint4 smem[];
  uint2* wf = reinterpret_cast<uint2*>(smem);
  bf16* ys = reinterpret_cast<bf16*>(wf + S::B_UNITS);  // two buffers
  bf16* st = ys + 2 * S::Y_ELEMS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q4 = lane & 3;
  const int H2 = 2 * H, W2 = 2 * W;
  const int tiles_x = (W + QW - 1) / QW, tiles_y = (H + S::QH - 1) / S::QH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;

  // B row kp = tap COP + c (tap-major), column n: w[tap, n, c] (zero
  // past co)
  tc::stage_b8<S::KSTEPS, CI>(
      wf,
      [=](int kp, int n) {
        const int tap = kp / S::COP, c = kp % S::COP;
        return c < CO ? w[(tap * CI + n) * CO + c] : __float2bfloat16(0.f);
      },
      tid, NT);

  // haloed dy pixel (ry, rx) of tile t → plane (ry & 1, rx & 1), pixel
  // (ry >> 1, rx >> 1) of it; zeros outside dy
  auto load = [&](int t, bf16* dst) {
    const int n = t / per_img, r = t % per_img;
    const int y0 = 2 * (r / tiles_x) * S::QH - 1;
    const int x0 = 2 * (r % tiles_x) * QW - 1;
    for (int e = tid; e < S::YH * S::YW * NC; e += NT) {
      const int p = e / NC, c = e % NC;
      const int ry = p / S::YW, rx = p % S::YW;
      const int iy = y0 + ry, ix = x0 + rx;
      const bool in = iy >= 0 && iy < H2 && ix >= 0 && ix < W2;
      const long pix = in ? ((long)n * H2 + iy) * W2 + ix : 0;
      const int pp = (ry >> 1) * S::PW + (rx >> 1);
      const uint32_t d =
          tc::smem_u32(dst + ((ry & 1) * 2 + (rx & 1)) * S::PLANE +
                       tc::chunk_at<NC>(pp, c) * 8);
      if constexpr (S::COP == CO)
        tc::cp_async16(d, dy + pix * CO + c * 8, in);
      else  // 8-channel streams: the plane's padding zero-filled
        tc::cp_chunk<CO * 2>(d, dy, dy + pix * CO, c, in);
    }
    tc::cp_async_commit();
  };

  const int ar = tc::a_row(lane), half = tc::a_half(lane);
  int base[J];  // the lane's plane pixel at offset (0, 0), per row
#pragma unroll
  for (int j = 0; j < J; ++j) base[j] = (warp * J + j) * S::PW + ar;
  bf16* wst = st + warp * S::ST;  // this warp's staging

  int buf = 0;
  if ((int)blockIdx.x < ntiles) load(blockIdx.x, ys);
#pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
    tc::cp_async_wait_all();
    __syncthreads();  // planes of tile t landed; the last tile's reads done
    if (t + (int)gridDim.x < ntiles)
      load(t + gridDim.x, ys + (buf ^ 1) * S::Y_ELEMS);
    const uint32_t yt = tc::smem_u32(ys + buf * S::Y_ELEMS);
    const int n = t / per_img, r = t % per_img;
    const int i0 = (r / tiles_x) * S::QH, j0 = (r % tiles_x) * QW;

    float acc[J][NT8][4];
    cg::zero_acc<S, J>(acc);

#pragma unroll 1
    for (int kr = 0; kr < 4; ++kr) {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        // plane (kr & 1, kc & 1) at offset (kr >> 1, kc >> 1); its base
        // (bytes) has no bit in the k-step XOR's place
        const uint32_t pbase = ((kr & 1) * 2 + (kc & 1)) * S::PLANE * 2;
        uint32_t off0[J];
#pragma unroll
        for (int j = 0; j < J; ++j)
          off0[j] = pbase + tc::a_off<NC>(
                                base[j] + (kr >> 1) * S::PW + (kc >> 1), half);
#pragma unroll
        for (int k2 = 0; k2 < S::KC; ++k2) {
          const int s = (kr * 4 + kc) * S::KC + k2;
          uint2 b[NT8];
#pragma unroll
          for (int tt = 0; tt < NT8; ++tt) b[tt] = wf[(s * NT8 + tt) * 32 + lane];
#pragma unroll
          for (int j = 0; j < J; ++j) {
            uint32_t a[4];
            tc::ldsm_x4(yt + (off0[j] ^ (k2 << 5)), a);
#pragma unroll
            for (int tt = 0; tt < NT8; ++tt)
              tc::mma(acc[j][tt], a, b[tt].x, b[tt].y);
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
        for (int tt = 0; tt < NT8; ++tt)
          *reinterpret_cast<bf162*>(wst + tc::elem_at<NCI>(sp, tt * 8 + 2 * q4)) =
              __floats2bfloat162_rn(acc[j][tt][2 * h], acc[j][tt][2 * h + 1]);
      }
    __syncwarp();
    tc::store_rows<NCI, J>(dx, wst, n, i0 + warp * J, j0, H, W, lane);
    __syncwarp();  // staging read before the next tile's epilogue
  }
}

template <int CI, int CO>
int launch(const void* dy, const void* w, void* dx, int B, int H, int W,
           cudaStream_t stream) {
  using S = S2k4Shape<CI, CO>;
  static bool smem_set = false;
  static int most = 0;
  cudaError_t e = allow_smem(conv_s2k4_kernel<CI, CO>, S::SMEM, &smem_set);
  if (e == cudaSuccess)
    e = tc::resident_blocks(conv_s2k4_kernel<CI, CO>, NT, S::SMEM, &most);
  if (e != cudaSuccess) return (int)e;
  const long tiles =
      (long)B * ((H + S::QH - 1) / S::QH) * ((W + QW - 1) / QW);
  if (tiles == 0) return 0;
  const int grid = (int)(tiles < most ? tiles : most);
  conv_s2k4_kernel<CI, CO><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const bf16*>(w),
      static_cast<bf16*>(dx), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co) of the deconv instantiated: UBR_CONV_S2K4_SHAPES, from the one
// table in ops/_build.py:SHAPES. H, W are dx's (the deconv's input side);
// dy must be 16-byte aligned.
UBR_EXPORT int ubr_conv_s2k4(const void* dy, const void* w, void* dx, int B,
                             int H, int W, int ci, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_S2K4(CI, CO) \
  if (ci == CI && co == CO) return launch<CI, CO>(dy, w, dx, B, H, W, s);
  UBR_CONV_S2K4_SHAPES(UBR_S2K4)
#undef UBR_S2K4
  return (int)cudaErrorInvalidValue;
}
