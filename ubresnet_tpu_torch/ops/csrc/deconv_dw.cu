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
// - Parity planes, as K8 (conv_s2k4.cu) loads them: tap (kr, kc) reads
//   plane (kr & 1, kc & 1) of the haloed dy tile at offset (kr >> 1,
//   kc >> 1), 16 consecutive pixels per k-step. The planes, the walk and
//   the GEMMs are parity_tiles.cuh's (pt::load_planes, pt::load_x,
//   pt::Walk, pt::Dw), shared with K8 and K10 (deconv2x_bwd.cu, which
//   computes dx and dW from one read of dy and adds the blocks' shares in
//   the same launch).
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
#include "parity_tiles.cuh"  // the tile walk, planes and K9's GEMMs
#include "partials.cuh"
#include "ubr_shapes.h"  // UBR_DECONV_DW_SHAPES (ops/_build.py:SHAPES)

namespace {

using pt::NT;

template <int CI, int CO>
struct DdwShape {
  static constexpr int TH = pt::tile_rows<CI, CO>();  // x rows of a tile
  // dy's planes hold co rounded up to whole chunks (N in n-tiles of 8)
  static constexpr int COP = (CO + 7) / 8 * 8;
  using D = pt::Dw<CI, CO, TH, COP / 8>;
  static constexpr int X_ELEMS = TH * pt::QW * D::CIP;  // bf16 of the x tile
  static constexpr int BUF = X_ELEMS + 4 * D::PLANE;    // bf16 of a buffer
  static constexpr int SMEM = 2 * BUF * 2;
  static constexpr int CAP = D::ACC > 64 ? 1 : 2;  // blocks an SM
};

template <int CI, int CO>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<DdwShape<CI, CO>::SMEM, DdwShape<CI, CO>::CAP>()))
deconv_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                 float* __restrict__ part, int B, int H, int W) {
  using S = DdwShape<CI, CO>;
  using D = typename S::D;
  extern __shared__ uint4 smem[];
  bf16* bufs = reinterpret_cast<bf16*>(smem);  // two (x tile, 4 planes)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const pt::Walk<S::TH> walk(B, H, W);
  const typename D::Lane ln(warp, lane);

  typename D::Acc acc;
  D::zero(acc);
  walk.run(
      [&](int t, int buf) {
        int n, i0, j0;
        walk.at(t, n, i0, j0);
        bf16* dst = bufs + buf * S::BUF;
        pt::load_x<CI, D::CIP, S::TH>(dst, x, n, i0, j0, H, W, tid);
        pt::load_planes<CO, S::COP, S::TH>(dst + S::X_ELEMS, dy, n, i0, j0,
                                           2 * H, 2 * W, tid);
        tc::cp_async_commit();
      },
      [&](int, int buf) {
        const uint32_t bt = tc::smem_u32(bufs + buf * S::BUF);
        D::tile(acc, bt, bt + S::X_ELEMS * 2, ln);
      });
  D::store(acc, part + (long)blockIdx.x * D::T, warp, lane);
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
  return (int)sum_rows(static_cast<const float*>(part), grid, S::D::T, 1.f,
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
