// K3 deconv2x — torch ConvTranspose2d(k=4, stride=2, padding=1,
// bias=False) at exactly 2x, NHWC bf16 in and out, f32 accumulation:
//   out[o] += w[k] * x[i]  where  o = 2i + k - 1  (per spatial axis).
// Each output pixel therefore reads a 2x2 set of input taps fixed by its
// row and column parity: even o uses k = 1 (i = o/2) and k = 3
// (i = o/2 - 1); odd o uses k = 2 (i = (o-1)/2) and k = 0 (i = (o+1)/2).
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:fused_packed_deconv2x
// (_deconv_kernel): the dec2 (128^2 x 64 -> 256^2 x 32) and dec1
// (256^2 x 32 -> 512^2 x 16) upsamples of the flagship UResNet. Weights
// arrive as (kh, kw, ci, co) — the reference checkpoint's IOHW layout
// permuted (2, 3, 0, 1), no spatial flip.
//
// Bound on the H100: bytes. 4 taps x CI x CO MACs per output pixel is
// 170 operations per byte moved at dec2 and 85 at dec1, below the ~295
// op/B bf16 tensor-core ridge: at b16, 100 MB (dec2) and 201 MB (dec1)
// at 3.35 TB/s, 0.030 + 0.060 ms.
//
// Design (tensor cores): each parity class (pa, pb) is an implicit GEMM
// [tile pixels x 4 CI] x [4 CI x CO] (K tap-major, then channel: 256 at
// dec2, 128 at dec1) on bf16 mma.sync m16n8k16 with f32 accumulators.
// - Weights once per block: a persistent grid (SMs x blocks per SM)
//   walks 16x16-pixel input tiles t = blockIdx.x + k * gridDim.x; each
//   block first lays all 16 taps out as B fragments in shared memory
//   (64 KB at dec2, 16 KB at dec1), instead of reloading them per tile.
// - x read once: one block takes an input tile with its one-pixel halo
//   (18x18) and all four parity classes of its 32x32 output, where the
//   first form gave each class its own block and read x four times.
// - Double-buffered cp.async: the next tile's 18x18 x CI tile streams in
//   (16-byte copies, zero-filled outside the image: the padding) while
//   this one computes; one barrier per tile.
// - ldmatrix A fragments straight from the pixel-major tile, the lane
//   giving its pixel's channel chunk at the tap's offset; the tile's
//   chunks are swizzled (tensor_core.cuh) so the 8 rows of a phase hit 8
//   bank groups.
// - Output: each warp owns two input rows, i.e. four output rows of 32
//   pixels; the two classes of one output-row parity are interleaved in
//   a per-warp staging buffer and written as whole rows with 16-byte
//   coalesced stores (the first form wrote 4 bytes at a 2-pixel stride).
// Shared memory: dec2 64 KB weights + 2 x 40.5 KB x + 32 KB staging =
// 177 KB (one block of 256 threads per SM); dec1 16 + 2 x 20.25 + 16 =
// 72.5 KB (three per SM).
//
// 8-channel streams (dec1 (16, 8) at inplanes 8; dec2 (16, 8) and dec1
// (8, 4) at 4): the tiles are zero-padded to the 16-channel k-step and
// n-tile pair (tc::pad16): ci = 8 reads 8 bf16 (one chunk) a pixel and
// zero-fills the tile's second chunk; the B rows past ci and the columns
// past co are zero; the staged output holds 16 channels and only co are
// stored (co = 4: element by element). 2x (4x at (8, 4)) the real MACs,
// still bound by bytes.
#include "tensor_core.cuh"
#include "ubr_shapes.h"  // UBR_DECONV2X_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int QH = 16, QW = 16;          // input pixels of a tile
constexpr int XH = QH + 2, XW = QW + 2;  // with the one-pixel halo
constexpr int NWARP = 8, NT = 32 * NWARP;
constexpr int RPW = QH / NWARP;          // tile rows a warp (M-tiles)

__device__ __forceinline__ int tap_k(int parity, int s) {
  return parity == 0 ? (s == 0 ? 1 : 3) : (s == 0 ? 2 : 0);
}
__device__ __forceinline__ int tap_di(int parity, int s) {
  return s == 0 ? 0 : (parity == 0 ? -1 : 1);
}

template <int CI, int CO>
struct DeconvShape {
  // channels of the x tile and the GEMMs' K, and of N
  static constexpr int CIP = tc::pad16(CI), COP = tc::pad16(CO);
  static constexpr int NCI = CIP / 8, NCO = COP / 8;  // 16-byte chunks/pixel
  static constexpr int KC = CIP / 16;                 // k-steps of one tap
  static constexpr int NQ = COP / 16;                 // n-tile pairs
  static constexpr int W_UNITS = 4 * 4 * CIP * COP / 8;  // uint4 of B
  static constexpr int X_ELEMS = XH * XW * CIP;
  static constexpr int ST_ELEMS = RPW * 2 * QW * COP;  // a warp's staging
  static_assert(CI % 8 == 0, "ci: whole 16-byte chunks");
  static constexpr int SMEM =
      W_UNITS * 16 + 2 * X_ELEMS * 2 + NWARP * ST_ELEMS * 2;
};

template <int CI, int CO>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<DeconvShape<CI, CO>::SMEM, 3>()))
deconv2x_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ out, int B, int H, int W) {
  using S = DeconvShape<CI, CO>;
  extern __shared__ uint4 smem[];
  uint4* wf = smem;
  bf16* xs = reinterpret_cast<bf16*>(smem + S::W_UNITS);
  bf16* st = xs + 2 * S::X_ELEMS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + QW - 1) / QW, tiles_y = (H + QH - 1) / QH;
  const int per_img = tiles_x * tiles_y;
  const int ntiles = B * per_img;
  const int Ho = 2 * H, Wo = 2 * W;
  bf16* wst = st + warp * S::ST_ELEMS;

  // class c = 2 pa + pb: B row s * CIP + ci is tap s = 2 sr + sc
  constexpr int CIP = S::CIP;
  const bf16 z = __float2bfloat16(0.f);
#pragma unroll 1
  for (int c = 0; c < 4; ++c)
    tc::stage_bv<4 * CIP, S::COP>(
        wf + c * (S::W_UNITS / 4),
        [&](int k, int n) {
          const int s = k / CIP, ci = k % CIP;
          const int kh = tap_k(c >> 1, s >> 1), kw = tap_k(c & 1, s & 1);
          return ci < CI && n < CO ? w[((kh * 4 + kw) * CI + ci) * CO + n]
                                   : z;
        },
        tid, NT);

  auto load = [=](int t, bf16* dst) {
    const int n = t / per_img, r = t % per_img;
    const int iy0 = (r / tiles_x) * QH - 1, ix0 = (r % tiles_x) * QW - 1;
    for (int e = tid; e < XH * XW * S::NCI; e += NT) {
      const int p = e / S::NCI, c = e % S::NCI;
      const int ih = iy0 + p / XW, iw = ix0 + p % XW;
      // a chunk past ci is the tile's padding: zero-filled
      const bool in =
          ih >= 0 && ih < H && iw >= 0 && iw < W &&
          (S::CIP == CI || c < CI / 8);
      const bf16* src = in ? x + (((long)n * H + ih) * W + iw) * CI + c * 8 : x;
      tc::cp_async16(tc::smem_u32(dst + tc::chunk_at<S::NCI>(p, c) * 8), src,
                     in);
    }
    tc::cp_async_commit();
  };

  const int g = lane >> 2, q4 = lane & 3;
  const int ar = tc::a_row(lane), ah = tc::a_half(lane);
  const int row0 = warp * RPW * XW + ar;  // lane's pixel in the tile, tap (0, 0)
  int buf = 0;
  if ((int)blockIdx.x < ntiles) load(blockIdx.x, xs);
#pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
    tc::cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with the other buffer
    if (t + (int)gridDim.x < ntiles)
      load(t + gridDim.x, xs + (buf ^ 1) * S::X_ELEMS);
    const bf16* xt = xs + buf * S::X_ELEMS;
    const int n = t / per_img, r = t % per_img;
    const int qy0 = (r / tiles_x) * QH, qx0 = (r % tiles_x) * QW;

    const uint32_t xt_u = tc::smem_u32(xt);
#pragma unroll
    for (int pa = 0; pa < 2; ++pa) {
#pragma unroll
      for (int pb = 0; pb < 2; ++pb) {
        const uint4* wc = wf + (2 * pa + pb) * (S::W_UNITS / 4);
        float acc[RPW][2 * S::NQ][4];
#pragma unroll
        for (int j = 0; j < RPW; ++j)
#pragma unroll
          for (int nt = 0; nt < 2 * S::NQ; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0.f;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int dy = 1 + tap_di(pa, s >> 1), dx = 1 + tap_di(pb, s & 1);
          uint32_t off[RPW];
#pragma unroll
          for (int j = 0; j < RPW; ++j)
            off[j] = tc::a_off<S::NCI>(row0 + (j + dy) * XW + dx, ah);
#pragma unroll
          for (int kc = 0; kc < S::KC; ++kc) {
            uint4 bq[S::NQ];
#pragma unroll
            for (int q = 0; q < S::NQ; ++q)
              bq[q] = wc[((s * S::KC + kc) * S::NQ + q) * 32 + lane];
#pragma unroll
            for (int j = 0; j < RPW; ++j) {
              uint32_t a[4];
              tc::ldsm_x4(xt_u + (off[j] ^ (kc << 5)), a);
#pragma unroll
              for (int q = 0; q < S::NQ; ++q) {
                tc::mma(acc[j][2 * q], a, bq[q].x, bq[q].y);
                tc::mma(acc[j][2 * q + 1], a, bq[q].z, bq[q].w);
              }
            }
          }
        }
        // staging pixel j * 2QW + (2 tx + pb) of this output-row parity
#pragma unroll
        for (int j = 0; j < RPW; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int sp = j * 2 * QW + 2 * (g + 8 * h) + pb;
#pragma unroll
            for (int nt = 0; nt < 2 * S::NQ; ++nt)
              *reinterpret_cast<bf162*>(
                  wst + tc::elem_at<S::NCO>(sp, nt * 8 + 2 * q4)) =
                  __floats2bfloat162_rn(acc[j][nt][2 * h],
                                        acc[j][nt][2 * h + 1]);
          }
      }
      __syncwarp();
      // output rows 2 (qy0 + ty) + pa of this warp's tile rows ty
      tc::store_staged<S::NCO, CO>(
          out, wst, RPW * 2 * QW,
          [=](int sp) -> long {
            const int oh = 2 * (qy0 + warp * RPW + sp / (2 * QW)) + pa;
            const int ow = 2 * qx0 + sp % (2 * QW);
            return oh < Ho && ow < Wo ? ((long)n * Ho + oh) * Wo + ow : -1;
          },
          lane);
      __syncwarp();
    }
  }
}

template <int CI, int CO>
int launch(const void* x, const void* w, void* out, int B, int H, int W,
           cudaStream_t stream) {
  using S = DeconvShape<CI, CO>;
  static bool smem_set = false;
  static int most = 0;
  cudaError_t e = allow_smem(deconv2x_kernel<CI, CO>, S::SMEM, &smem_set);
  if (e == cudaSuccess)
    e = tc::resident_blocks(deconv2x_kernel<CI, CO>, NT, S::SMEM, &most);
  if (e != cudaSuccess) return (int)e;
  const long tiles =
      (long)B * ((H + QH - 1) / QH) * ((W + QW - 1) / QW);
  if (tiles == 0) return 0;
  const int grid = (int)(tiles < most ? tiles : most);
  deconv2x_kernel<CI, CO><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co) instantiated: UBR_DECONV2X_SHAPES, from the one table in
// ops/_build.py:SHAPES.
UBR_EXPORT int ubr_deconv2x(const void* x, const void* w, void* out, int B,
                            int H, int W, int ci, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_DECONV(CI, CO) \
  if (ci == CI && co == CO) return launch<CI, CO>(x, w, out, B, H, W, s);
  UBR_DECONV2X_SHAPES(UBR_DECONV)
#undef UBR_DECONV
  return (int)cudaErrorInvalidValue;
}
