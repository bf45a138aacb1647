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
// - Parity planes: the haloed dy tile lands as its four (row parity,
//   column parity) planes, each swizzled on its own, so tap (kr, kc)'s
//   A rows are 16 consecutive pixels of plane (kr & 1, kc & 1), the
//   access pattern of K1's conv_rows, conflict-free for ldmatrix.
// - A persistent grid (SMs x blocks per SM, asked once per kernel
//   instance) walks dx tiles; the next tile's planes arrive by
//   double-buffered 16-byte cp.async while this one is computed.
// - 8 warps, J dx rows (M-tiles) each; the epilogue rounds to bf16 and
//   stages the warp's rows for 16-byte coalesced stores.
// The planes, the walk and the GEMM are parity_tiles.cuh's (pt::Walk,
// pt::load_planes, pt::Dx), shared with K9 and K10 (deconv2x_bwd.cu, which
// computes dx and dW from one read of dy).
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
#include "parity_tiles.cuh"  // the tile walk, planes and K8's GEMM
#include "ubr_shapes.h"  // UBR_CONV_S2K4_SHAPES (ops/_build.py:SHAPES)

namespace {

using pt::NT;

template <int CI, int CO>
struct S2k4Shape {
  static constexpr int QH = pt::tile_rows<CI, CO>();  // dx rows of a tile
  using D = pt::Dx<CI, CO, QH>;
  static constexpr int Y_ELEMS = 4 * D::PLANE;         // bf16 of a buffer
  static constexpr int SMEM =
      D::B_UNITS * 8 + (2 * Y_ELEMS + pt::NWARP * D::ST) * 2;
};

template <int CI, int CO>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<S2k4Shape<CI, CO>::SMEM, 2>()))
conv_s2k4_kernel(const bf16* __restrict__ dy, const bf16* __restrict__ w,
                 bf16* __restrict__ dx, int B, int H, int W) {
  using S = S2k4Shape<CI, CO>;
  using D = typename S::D;
  extern __shared__ uint4 smem[];
  uint2* wf = reinterpret_cast<uint2*>(smem);
  bf16* ys = reinterpret_cast<bf16*>(wf + D::B_UNITS);  // two buffers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* wst = ys + 2 * S::Y_ELEMS + warp * D::ST;  // this warp's staging
  const pt::Walk<S::QH> walk(B, H, W);

  D::stage_w(wf, w, tid);
  walk.run(
      [&](int t, int buf) {
        int n, i0, j0;
        walk.at(t, n, i0, j0);
        pt::load_planes<CO, D::COP, S::QH>(ys + buf * S::Y_ELEMS, dy, n, i0,
                                           j0, 2 * H, 2 * W, tid);
        tc::cp_async_commit();
      },
      [&](int t, int buf) {
        int n, i0, j0;
        walk.at(t, n, i0, j0);
        D::tile(dx, tc::smem_u32(ys + buf * S::Y_ELEMS), wf, wst, n, i0, j0,
                H, W, warp, lane);
      });
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
  const long tiles = (long)B * ((H + S::QH - 1) / S::QH) *
                     ((W + pt::QW - 1) / pt::QW);
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
