// K3-s8 deconv2x_s8 — the int8 mode of K3: torch ConvTranspose2d(k=4,
// stride=2, padding=1, bias=False) at exactly 2x of an NHWC int8 tensor
// with an int8 (kh, kw, ci, co) kernel, exact s32 accumulation, then the
// dequant out = f32(acc) * g[co] (g = sx·sw), stored as bf16 (the model)
// or float (checks). Tap geometry as K3: out[o] += w[k]·x[i] with
// o = 2i + k - 1, so each output pixel reads a 2x2 set of input taps
// fixed by its row and column parity.
//
// Replaces the quantized=True mode of
// ubresnet_tpu/ops/pallas_conv.py:fused_packed_deconv2x
// (_deconv_kernel): the dec2 (128^2 x 64 -> 256^2 x 32) and dec1
// (256^2 x 32 -> 512^2 x 16) upsamples of the flagship UResNet under
// int8 deploy.
//
// Bound on the H100: bytes (4 taps x CI x CO MACs per output pixel
// against CI/4 + 2·CO bytes moved is 205 op/B at dec2 and 102 at dec1,
// under the ~590 op/B int8 ridge): at b16, 84 MB (dec2) and 168 MB
// (dec1) at 3.35 TB/s, 0.025 + 0.050 ms.
//
// Design (int8 tensor cores): K3's (deconv2x.cu) carried to m16n8k32.
// Each parity class (pa, pb) is an implicit GEMM [tile pixels x 4 CI] x
// [4 CI x CO] (K tap-major, then channel) on mma.sync m16n8k32 with exact
// s32 accumulators: 8 k-steps of 32 at dec2, 4 at dec1.
// - Weights once per block: a persistent grid (SMs x blocks per SM)
//   walks 16x16-pixel input tiles t = blockIdx.x + k * gridDim.x; each
//   block first lays all 16 taps out as s8 B fragments in shared memory
//   (tc::stage_b_s8: 32 KB at dec2, 8 KB at dec1).
// - x read once: one block takes an input tile with its one-pixel halo
//   (18x18) and all four parity classes of its 32x32 output.
// - Double-buffered cp.async: the next tile's 18x18 x CI int8 tile
//   streams in (16-byte copies, zero-filled outside the image: the
//   padding) while this one computes; one barrier per tile.
// - ldmatrix A fragments straight from the pixel-major tile, the lane
//   giving its pixel's 16-channel chunk at the tap's offset; the tile's
//   chunks are swizzled (tc::chunk_at, 4 a pixel at dec2, 2 at dec1) so
//   the 8 rows of a phase hit 8 bank groups.
// - Output: each warp owns two input rows, i.e. four output rows of 32
//   pixels; the two classes of one output-row parity are interleaved in
//   a per-warp staging buffer and written as whole rows with 16-byte
//   coalesced stores. The dequant is deconv2x_s8_plain's one f32
//   multiply, so the f32 output is bit-identical to the plain version's.
// Shared memory (weights + 2 x tiles + staging, bf16 / f32 out): dec2
// 32 + 41.5 + 32 / 64 KB = 106 / 138 KB (two blocks an SM, one with
// f32); dec1 8 + 20.7 + 16 / 32 KB = 45 / 61 KB (three an SM). The two
// column parities of a row parity are unrolled: dec2 then spills 16 B
// at its 128 registers, and still runs 2% faster on the H100 than
// without that unroll, which spills nothing (PERF.md).
//
// 8-channel streams (dec1 (16, 8) at inplanes 8; dec2 (16, 8) and dec1
// (8, 4) at 4): the x tile is zero-padded to one 32-channel k-step (ci
// = 16 copies one chunk a pixel and zero-fills the second, ci = 8 half a
// chunk, tc::cp_chunk), N to one 16-column n-tile pair, with zero B rows
// and columns and zero gains past co; the staged output holds 16
// channels and only co are stored (co = 4: element by element). 2x and
// 8x the real MACs, exact: the float32 output stays bit-identical to
// deconv2x_s8_plain's.
#include "tensor_core.cuh"
#include "ubr_shapes.h"  // UBR_DECONV2X_S8_SHAPES (ops/_build.py:SHAPES)

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

template <int CI, int CO, typename OT>
struct DeconvS8Shape {
  // channels of the x tile and K (32-channel k-steps), and of N (16-column
  // n-tile pairs)
  static constexpr int CIP = (CI + 31) / 32 * 32, COP = tc::pad16(CO);
  static_assert(CI % 8 == 0, "ci: whole 8-byte units");
  static constexpr int NCI = CIP / 16;              // int8 chunks a pixel
  static constexpr int KC = CIP / 32;               // k-steps of one tap
  static constexpr int KS = 4 * KC;                 // k-steps of a class
  static constexpr int NQ = COP / 16;               // n-tile pairs
  static constexpr int ES = 16 / (int)sizeof(OT);   // outputs a chunk
  static constexpr int NCS = COP / ES;              // staged chunks a pixel
  static constexpr int W_UNITS = 4 * KS * NQ * 32;  // uint4 of B, 4 classes
  static constexpr int X_BYTES = XH * XW * CIP;
  static constexpr int ST = RPW * 2 * QW * COP;     // staged outputs a warp
  static constexpr int SMEM = W_UNITS * 16 + COP * 4 + 2 * X_BYTES +
                              NWARP * ST * (int)sizeof(OT);
};

template <int CI, int CO, typename OT>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<DeconvS8Shape<CI, CO, OT>::SMEM, 3>()))
deconv2x_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ g, OT* __restrict__ out, int B,
                   int H, int W) {
  using S = DeconvS8Shape<CI, CO, OT>;
  constexpr int NCI = S::NCI, KC = S::KC, NQ = S::NQ;
  constexpr int NCS = S::NCS, ES = S::ES;
  constexpr int CIP = S::CIP, COP = S::COP;
  extern __shared__ uint4 smem[];
  uint4* wf = smem;
  float* gs = reinterpret_cast<float*>(smem + S::W_UNITS);
  int8_t* xs = reinterpret_cast<int8_t*>(gs + COP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (W + QW - 1) / QW, tiles_y = (H + QH - 1) / QH;
  const int per_img = tiles_x * tiles_y;
  const int ntiles = B * per_img;
  const int Ho = 2 * H, Wo = 2 * W;
  OT* wst = reinterpret_cast<OT*>(xs + 2 * S::X_BYTES) + warp * S::ST;

  // class c = 2 pa + pb: B row k is tap s = k / CIP (s = 2 sr + sc),
  // channel k % CIP (zero past ci and past co)
#pragma unroll 1
  for (int c = 0; c < 4; ++c)
    tc::stage_b_s8<S::KS, COP>(
        wf + c * (S::W_UNITS / 4),
        [&](int k, int n) {
          const int s = k / CIP, ci = k % CIP;
          const int kh = tap_k(c >> 1, s >> 1), kw = tap_k(c & 1, s & 1);
          return ci < CI && n < CO ? w[((kh * 4 + kw) * CI + ci) * CO + n]
                                   : (int8_t)0;
        },
        tid, NT);
  for (int e = tid; e < COP; e += NT) gs[e] = e < CO ? g[e] : 0.f;

  auto load = [=](int t, int8_t* dst) {
    const int n = t / per_img, r = t % per_img;
    const int iy0 = (r / tiles_x) * QH - 1, ix0 = (r % tiles_x) * QW - 1;
    for (int e = tid; e < XH * XW * NCI; e += NT) {
      const int p = e / NCI, c = e % NCI;
      const int ih = iy0 + p / XW, iw = ix0 + p % XW;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const int8_t* src = in ? x + (((long)n * H + ih) * W + iw) * CI : x;
      const uint32_t d = tc::smem_u32(dst + tc::chunk_at<NCI>(p, c) * 16);
      if constexpr (CIP == CI)
        tc::cp_async16(d, in ? src + c * 16 : x, in);
      else  // 8-channel streams: the tile's padding zero-filled
        tc::cp_chunk<CI>(d, x, src, c, in);
    }
    tc::cp_async_commit();
  };

  const int g8 = lane >> 2, q4 = lane & 3;
  const int ar = tc::a_row(lane), ah = tc::a_half(lane);
  const int row0 = warp * RPW * XW + ar;  // lane's pixel in the tile, tap (0, 0)
  int buf = 0;
  if ((int)blockIdx.x < ntiles) load(blockIdx.x, xs);
#pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
    tc::cp_async_wait_all();
    __syncthreads();  // tile t landed; every warp is done with the other buffer
    if (t + (int)gridDim.x < ntiles)
      load(t + gridDim.x, xs + (buf ^ 1) * S::X_BYTES);
    const uint32_t xt_u = tc::smem_u32(xs + buf * S::X_BYTES);
    const int n = t / per_img, r = t % per_img;
    const int qy0 = (r / tiles_x) * QH, qx0 = (r % tiles_x) * QW;

#pragma unroll 1
    for (int pa = 0; pa < 2; ++pa) {
#pragma unroll
      for (int pb = 0; pb < 2; ++pb) {
        const uint4* wc = wf + (2 * pa + pb) * (S::W_UNITS / 4);
        int acc[RPW][2 * NQ][4];
#pragma unroll
        for (int j = 0; j < RPW; ++j)
#pragma unroll
          for (int nt = 0; nt < 2 * NQ; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[j][nt][i] = 0;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int dy = 1 + tap_di(pa, s >> 1), dx = 1 + tap_di(pb, s & 1);
          uint32_t off[RPW];
#pragma unroll
          for (int j = 0; j < RPW; ++j)
            off[j] = tc::a_off<NCI>(row0 + (j + dy) * XW + dx, ah);
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            uint4 bq[NQ];
#pragma unroll
            for (int q = 0; q < NQ; ++q)
              bq[q] = wc[((s * KC + kc) * NQ + q) * 32 + lane];
#pragma unroll
            for (int j = 0; j < RPW; ++j) {
              uint32_t a[4];
              tc::ldsm_x4(xt_u + (off[j] ^ (kc << 5)), a);
#pragma unroll
              for (int q = 0; q < NQ; ++q) {
                tc::mma_s8(acc[j][2 * q], a, bq[q].x, bq[q].y);
                tc::mma_s8(acc[j][2 * q + 1], a, bq[q].z, bq[q].w);
              }
            }
          }
        }
        // dequant -> staging pixel j * 2QW + (2 tx + pb) of this
        // output-row parity
#pragma unroll
        for (int nt = 0; nt < 2 * NQ; ++nt) {
          const int ch = nt * 8 + 2 * q4;
          const float2 gg = *reinterpret_cast<const float2*>(gs + ch);
#pragma unroll
          for (int j = 0; j < RPW; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int sp = j * 2 * QW + 2 * (g8 + 8 * h) + pb;
              put2(wst + tc::elem_at<NCS, ES>(sp, ch),
                   __fmul_rn(__int2float_rn(acc[j][nt][2 * h]), gg.x),
                   __fmul_rn(__int2float_rn(acc[j][nt][2 * h + 1]), gg.y));
            }
        }
      }
      __syncwarp();
      // output rows 2 (qy0 + ty) + pa of this warp's tile rows ty
      tc::store_staged<NCS, CO>(
          out, wst, RPW * 2 * QW,
          [=](int sp) -> long {
            const int oh = 2 * (qy0 + warp * RPW + sp / (2 * QW)) + pa;
            const int ow = 2 * qx0 + sp % (2 * QW);
            return oh < Ho && ow < Wo ? ((long)n * Ho + oh) * Wo + ow : -1;
          },
          lane);
      __syncwarp();  // staging read before the next parity's dequant
    }
  }
}

template <int CI, int CO, typename OT>
int launch(const void* x, const void* w, const void* g, void* out, int B,
           int H, int W, cudaStream_t stream) {
  using S = DeconvS8Shape<CI, CO, OT>;
  static bool smem_set = false;
  static int most = 0;
  cudaError_t e =
      allow_smem(deconv2x_s8_kernel<CI, CO, OT>, S::SMEM, &smem_set);
  if (e == cudaSuccess)
    e = tc::resident_blocks(deconv2x_s8_kernel<CI, CO, OT>, NT, S::SMEM,
                            &most);
  if (e != cudaSuccess) return (int)e;
  const long tiles = (long)B * ((H + QH - 1) / QH) * ((W + QW - 1) / QW);
  if (tiles == 0) return 0;
  const int grid = (int)(tiles < most ? tiles : most);
  deconv2x_s8_kernel<CI, CO, OT><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(g), static_cast<OT*>(out), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co) instantiated: UBR_DECONV2X_S8_SHAPES, from the one table in
// ops/_build.py:SHAPES; out_f32 selects a float output instead of bf16.
// x must be 16-byte aligned.
UBR_EXPORT int ubr_deconv2x_s8(const void* x, const void* w, const void* g,
                               void* out, int B, int H, int W, int ci, int co,
                               int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_DECONV_S8(CI, CO)                                             \
  if (ci == CI && co == CO)                                               \
    return out_f32 ? launch<CI, CO, float>(x, w, g, out, B, H, W, s)      \
                   : launch<CI, CO, bf16>(x, w, g, out, B, H, W, s);
  UBR_DECONV2X_S8_SHAPES(UBR_DECONV_S8)
#undef UBR_DECONV_S8
  return (int)cudaErrorInvalidValue;
}
