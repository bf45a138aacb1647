// K1-s8 conv_bn_act_s8 — the int8 mode of K1: stride-1, odd k x k 'same'
// convolution of an NHWC int8 tensor with an int8 (k, k, ci, co) kernel,
// exact s32 accumulation, then the eval epilogue in float32
//   y = f32(acc) * g + b -> [ReLU] (pre-add) -> [+ residual] -> [ReLU]
// stored as bf16 (the model) or float (checks). g carries the dequant
// scale sx * sw folded into the BN gain (ops/quant.py).
//
// Replaces the quantized=True mode of
// ubresnet_tpu/ops/pallas_conv.py:fused_packed_conv (_conv_kernel): the
// UResNet head conv10 (7x7 16->16 + bias + BN + ReLU) under int8 deploy.
//
// Bound on the H100: bytes at the int8 tensor-core peak (7x7x16x16 MACs
// per output pixel against 16 + 32 bytes moved is 523 op/B, just under
// the ~590 op/B int8 ridge): at 512^2, b16, 67 MB in and 134 MB out at
// 3.35 TB/s, 0.060 ms.
//
// Design (int8 tensor cores): K1's implicit GEMM (conv_gemm.cuh with
// T = int8_t: M = 16x16 output pixels of a tile, N = co, K = taps x ci
// tap-major) on mma.sync m16n8k32 with exact s32 accumulators:
// - at ci = 16 a pixel is one 16-byte chunk and a 32-deep k-step covers
//   two taps (lanes 0-15 the first tap's pixel, lanes 16-31 the
//   second's): 25 k-steps over the 49 taps and a phantom 50th with zero
//   weight rows, half of bf16 K1's 49 k-steps of 16;
// - a persistent grid (SMs x blocks per SM, asked once per kernel
//   instance) walks tiles t = blockIdx.x + i * gridDim.x; each block lays
//   the weights out once as s8 B fragments in shared memory (12.8 KB);
// - the next tile's 22x22 haloed int8 x tile (7.7 KB) arrives by
//   double-buffered 16-byte cp.async (zero-filled outside the image)
//   while this one is computed;
// - 8 warps, two output rows (M-tiles) each, every k-step's B fragments
//   shared by both;
// - the epilogue is conv_bn_act_s8_plain's f32 arithmetic step for step
//   (affine_fma, fmaxf, __fadd_rn, fmaxf); s32 sums are exact in any
//   order, so the f32 output is bit-identical to the plain version's;
// - each warp stages its two output rows (bf16 or float) in its own
//   swizzled shared-memory rows and writes them as 16-byte chunks
//   (tc::store_rows).
// Shared memory: 12.8 KB weights + 2 x 7.7 KB x + 8 KB staging = 36 KB
// with bf16 output (44 KB with float); __launch_bounds__ asks for four
// blocks an SM (64 registers a thread).
//
// 8-channel streams (the inplanes-8 head conv10 (8, 16, 7); at inplanes
// 4 the per-conv blocks' (8, 8, 3), (8, 4, 3) and (8, 4, 1)): an 8-byte
// int8 pixel lands in a 16-byte tile pixel whose second half is zero
// (written once, conv_gemm.cuh:zero_pad; its B rows zero), so a k-step
// still covers two taps: 2x the real MACs, exact all the same. co = 4
// pads N to 8 with zero B columns, gains and biases; the staged tile
// holds 8 channels and only the real 4 are stored.
#include "conv_gemm.cuh"
#include "ubr_shapes.h"  // UBR_CONV_BN_ACT_S8_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int NWARP = 8, NT = 32 * NWARP;
constexpr int J = cg::TH / NWARP;  // output rows a warp

template <int CI, int CO, int K, typename OT>
struct ConvS8Shape : cg::Shape<CI, CO, K, int8_t> {
  using G = cg::Shape<CI, CO, K, int8_t>;
  static constexpr int ES = 16 / (int)sizeof(OT);  // outputs a chunk
  static constexpr int NCS = G::COP / ES;          // staged chunks a pixel
  static constexpr int ST = J * cg::TW * G::COP;   // staged outputs a warp
  static constexpr int SMEM = G::B_UNITS * 8 + 2 * G::COP * 4 +
                              2 * G::X_ELEMS + NWARP * ST * (int)sizeof(OT);
};

template <int CI, int CO, int K, typename OT>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<ConvS8Shape<CI, CO, K, OT>::SMEM, 4>()))
conv_bn_act_s8_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ g,
                      const float* __restrict__ bias,
                      const OT* __restrict__ res, OT* __restrict__ out, int B,
                      int H, int W, int pre_act, int act) {
  using S = ConvS8Shape<CI, CO, K, OT>;
  constexpr int NT8 = S::NT8, NCS = S::NCS, ES = S::ES, COP = S::COP;
  extern __shared__ uint4 smem[];
  uint2* wf = reinterpret_cast<uint2*>(smem);
  float* prm = reinterpret_cast<float*>(wf + S::B_UNITS);  // g | b
  int8_t* xs = reinterpret_cast<int8_t*>(prm + 2 * COP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q4 = lane & 3;
  const int tiles_x = (W + cg::TW - 1) / cg::TW;
  const int tiles_y = (H + cg::TH - 1) / cg::TH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;
  OT* wst = reinterpret_cast<OT*>(xs + 2 * S::X_ELEMS) + warp * S::ST;

  cg::stage_w<S>(wf, w, CI, CO, tid, NT);
  for (int e = tid; e < COP; e += NT) {
    prm[e] = e < CO ? g[e] : 0.f;
    prm[COP + e] = e < CO ? bias[e] : 0.f;
  }
  cg::zero_pad<S>(xs, 2, tid, NT);

  auto load = [&](int t, int8_t* dst) {
    const int n = t / per_img, r = t % per_img;
    cg::load_x<S>(dst, x, n, (r / tiles_x) * cg::TH, (r % tiles_x) * cg::TW,
                  H, W, tid, NT);
  };

  int row[J];
#pragma unroll
  for (int j = 0; j < J; ++j) row[j] = warp * J + j;

  int buf = 0;
  if ((int)blockIdx.x < ntiles) load(blockIdx.x, xs);
#pragma unroll 1
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x, buf ^= 1) {
    tc::cp_async_wait_all();
    __syncthreads();  // x of tile t landed; the last tile's reads are done
    if (t + (int)gridDim.x < ntiles)
      load(t + gridDim.x, xs + (buf ^ 1) * S::X_ELEMS);
    const int n = t / per_img, r = t % per_img;
    const int oh0 = (r / tiles_x) * cg::TH, ow0 = (r % tiles_x) * cg::TW;

    int acc[J][NT8][4];
    cg::zero_acc<S, J>(acc);
    cg::conv_rows<S, J>(acc, tc::smem_u32(xs + buf * S::X_ELEMS), wf, row,
                        lane);

    // epilogue -> this warp's staging (pixel sp = j * TW + px)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int oh = oh0 + row[j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = gq + 8 * h, ow = ow0 + px;
        const bool in = oh < H && ow < W;
        const long pix = ((long)n * H + oh) * W + ow;
#pragma unroll
        for (int tt = 0; tt < NT8; ++tt) {
          const int ch = tt * 8 + 2 * q4;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float y = affine_fma(acc[j][tt][2 * h + e], prm[ch + e],
                                 prm[COP + ch + e]);
            if (pre_act) y = fmaxf(y, 0.f);
            if (res != nullptr && in && ch + e < CO)
              y = __fadd_rn(y, to_f32(res[pix * CO + ch + e]));
            if (act) y = fmaxf(y, 0.f);
            v[e] = y;
          }
          put2(wst + tc::elem_at<NCS, ES>(j * cg::TW + px, ch), v[0], v[1]);
        }
      }
    }
    __syncwarp();
    tc::store_rows<NCS, J, CO>(out, wst, n, oh0 + warp * J, ow0, H, W,
                               lane);
    __syncwarp();  // staging read before the next tile's epilogue
  }
}

template <int CI, int CO, int K, typename OT>
int launch(const void* x, const void* w, const void* g, const void* b,
           const void* res, void* out, int B, int H, int W, int pre_act,
           int act, cudaStream_t stream) {
  using S = ConvS8Shape<CI, CO, K, OT>;
  static bool smem_set = false;
  static int most = 0;
  cudaError_t e =
      allow_smem(conv_bn_act_s8_kernel<CI, CO, K, OT>, S::SMEM, &smem_set);
  if (e == cudaSuccess)
    e = tc::resident_blocks(conv_bn_act_s8_kernel<CI, CO, K, OT>, NT,
                            S::SMEM, &most);
  if (e != cudaSuccess) return (int)e;
  const long tiles = (long)B * ((H + cg::TH - 1) / cg::TH) *
                     ((W + cg::TW - 1) / cg::TW);
  if (tiles == 0) return 0;
  const int grid = (int)(tiles < most ? tiles : most);
  conv_bn_act_s8_kernel<CI, CO, K, OT><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const OT*>(res), static_cast<OT*>(out), B, H, W, pre_act,
      act);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co, k) instantiated: UBR_CONV_BN_ACT_S8_SHAPES, from the one
// table in ops/_build.py:SHAPES; out_f32 selects a float output (and
// residual) instead of bf16. x must be 16-byte aligned.
UBR_EXPORT int ubr_conv_bn_act_s8(const void* x, const void* w,
                                  const void* g, const void* b,
                                  const void* res, void* out, int B, int H,
                                  int W, int ci, int co, int k, int pre_act,
                                  int act, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_CONV_S8(CI, CO, K)                                               \
  if (ci == CI && co == CO && k == K)                                        \
    return out_f32 ? launch<CI, CO, K, float>(x, w, g, b, res, out, B, H, W, \
                                              pre_act, act, s)               \
                   : launch<CI, CO, K, bf16>(x, w, g, b, res, out, B, H, W,  \
                                             pre_act, act, s);
  UBR_CONV_BN_ACT_S8_SHAPES(UBR_CONV_S8)
#undef UBR_CONV_S8
  return (int)cudaErrorInvalidValue;
}
