// K1 conv_bn_act — stride-1, odd k x k 'same' convolution over an NHWC
// bf16 tensor, f32 accumulation, then the eval epilogue
//   y = acc * g + b -> [ReLU] (pre-add) -> [+ residual] -> [ReLU]
// stored as bf16.
//
// Replaces ubresnet_tpu/ops/pallas_conv.py:fused_packed_conv
// (_conv_kernel) — the UResNet head conv10 (7x7 16->16 + bias + BN +
// ReLU) and classifier conv11 (7x7 16->3 + bias, g = 1, no ReLU) at the
// full crop resolution — and the input-gradient leg of pallas_conv_ad
// (the wrapper's conv_input_grad: dy with the flipped, transposed
// kernel). The TPU kernel's W-packing and halo-combo blocks exist only
// to fill 128-lane tiles and are not carried over.
//
// Bound on the H100: operations at 7x7 (7x7x16x16 MACs per output pixel
// is 25,088 operations per 64 bytes moved, above the ~295 op/B bf16
// ridge); bytes at 3x3 and 1x1 and for the 3-class classifier.
//
// Design (tensor cores): one implicit GEMM for every shape
// (conv_gemm.cuh: M = 16x16 output pixels of a tile, N = co, K = taps x
// ci tap-major) on bf16 mma.sync m16n8k16 with f32 accumulators, as K2:
// - a persistent grid (SMs x blocks per SM, asked once per kernel
//   instance) walks tiles t = blockIdx.x + i * gridDim.x; each block lays
//   the weights out once as B fragments in shared memory;
// - the next tile's haloed x tile arrives by double-buffered cp.async
//   (zero-filled outside the image) while this one is computed;
// - 8 warps, two output rows (M-tiles) each, every k-step's B fragments
//   shared by both;
// - the epilogue runs on the accumulators; the output goes through a
//   per-warp staging area in shared memory to 16-byte coalesced stores
//   (co = 3 or 4: coalesced 2-byte stores of the packed pixels).
// co = 3 or 4 pads N to 8 (B columns past co zero, never stored); ci = 4
// and 8 put two taps in a k-step (conv_gemm.cuh) — the 8-channel streams
// of the inplanes-8 and -4 UResNets (their head conv10, the per-conv
// blocks' convs at 4 and the train zone's input gradients).
#include "conv_gemm.cuh"
#include "ubr_shapes.h"  // UBR_CONV_BN_ACT_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int NWARP = 8, NT = 32 * NWARP;
constexpr int J = cg::TH / NWARP;  // output rows a warp

template <int CI, int CO, int K>
struct ConvShape : cg::Shape<CI, CO, K> {
  using G = cg::Shape<CI, CO, K>;
  static constexpr int NCO = G::COP / 8;           // staging chunks a pixel
  static constexpr int ST = J * cg::TW * G::COP;   // staging bf16 a warp
  static constexpr int SMEM = G::B_UNITS * 8 + 2 * G::COP * 4 +
                              (2 * G::X_ELEMS + NWARP * ST) * 2;
  // registers: the accumulators are J x COP / 2 a thread
  static constexpr int CAP = G::COP <= 16 ? 4 : (G::COP <= 32 ? 3 : 2);
};

// Byte offset of channel ch (even for CO % 8 == 0) of staged pixel sp.
template <int CO, int NCO>
__device__ __forceinline__ int stage_at(int sp, int ch) {
  if constexpr (CO % 8 == 0)
    return tc::elem_at<NCO>(sp, ch);
  else
    return sp * CO + ch;
}

template <int CI, int CO, int K>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<ConvShape<CI, CO, K>::SMEM,
                           ConvShape<CI, CO, K>::CAP>()))
conv_bn_act_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ g, const float* __restrict__ bias,
                   const bf16* __restrict__ res, bf16* __restrict__ out,
                   int B, int H, int W, int pre_act, int act) {
  using S = ConvShape<CI, CO, K>;
  constexpr int NT8 = S::NT8, NCO = S::NCO;
  extern __shared__ uint4 smem[];
  uint2* wf = reinterpret_cast<uint2*>(smem);
  float* prm = reinterpret_cast<float*>(wf + S::B_UNITS);  // g | b
  bf16* xs = reinterpret_cast<bf16*>(prm + 2 * S::COP);
  bf16* st = xs + 2 * S::X_ELEMS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q4 = lane & 3;
  const int tiles_x = (W + cg::TW - 1) / cg::TW;
  const int tiles_y = (H + cg::TH - 1) / cg::TH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;

  cg::stage_w<S>(wf, w, CI, CO, tid, NT);
  for (int e = tid; e < S::COP; e += NT) {
    prm[e] = e < CO ? g[e] : 0.f;
    prm[S::COP + e] = e < CO ? bias[e] : 0.f;
  }
  cg::zero_pad<S>(xs, 2, tid, NT);

  auto load = [&](int t, bf16* dst) {
    const int n = t / per_img, r = t % per_img;
    cg::load_x<S>(dst, x, n, (r / tiles_x) * cg::TH, (r % tiles_x) * cg::TW,
                  H, W, tid, NT);
  };

  int row[J];
#pragma unroll
  for (int j = 0; j < J; ++j) row[j] = warp * J + j;
  bf16* wst = st + warp * S::ST;  // this warp's staging

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

    float acc[J][NT8][4];
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
            float y = acc[j][tt][2 * h + e] * prm[ch + e] + prm[S::COP + ch + e];
            if (pre_act) y = fmaxf(y, 0.f);
            if (res != nullptr && in && ch + e < CO)
              y += __bfloat162float(res[pix * CO + ch + e]);
            if (act) y = fmaxf(y, 0.f);
            v[e] = y;
          }
          const int sp = j * cg::TW + px;
          if constexpr (CO % 8 == 0) {
            *reinterpret_cast<bf162*>(wst + stage_at<CO, NCO>(sp, ch)) =
                __floats2bfloat162_rn(v[0], v[1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (ch + e < CO)
                wst[stage_at<CO, NCO>(sp, ch + e)] = __float2bfloat16(v[e]);
          }
        }
      }
    }
    __syncwarp();
    // this warp's output rows: whole 16-byte chunks, or (co = 3 or 4)
    // the packed pixels element by element
    if constexpr (CO % 8 == 0) {
      tc::store_rows<NCO, J>(out, wst, n, oh0 + warp * J, ow0, H, W, lane);
    } else {
      for (int e = lane; e < J * cg::TW * CO; e += 32) {
        const int sp = e / CO, c = e % CO;
        const int oh = oh0 + warp * J + sp / cg::TW, ow = ow0 + sp % cg::TW;
        if (oh < H && ow < W)
          out[(((long)n * H + oh) * W + ow) * CO + c] = wst[e];
      }
    }
    __syncwarp();  // staging read before the next tile's epilogue
  }
}

template <int CI, int CO, int K>
int launch(const void* x, const void* w, const void* g, const void* b,
           const void* res, void* out, int B, int H, int W, int pre_act,
           int act, cudaStream_t stream) {
  using S = ConvShape<CI, CO, K>;
  static bool smem_set = false;
  static int most = 0;
  cudaError_t e =
      allow_smem(conv_bn_act_kernel<CI, CO, K>, S::SMEM, &smem_set);
  if (e == cudaSuccess)
    e = tc::resident_blocks(conv_bn_act_kernel<CI, CO, K>, NT, S::SMEM,
                            &most);
  if (e != cudaSuccess) return (int)e;
  const long tiles = (long)B * ((H + cg::TH - 1) / cg::TH) *
                     ((W + cg::TW - 1) / cg::TW);
  if (tiles == 0) return 0;
  const int grid = (int)(tiles < most ? tiles : most);
  conv_bn_act_kernel<CI, CO, K><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const bf16*>(res), static_cast<bf16*>(out), B, H, W,
      pre_act, act);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co, k) instantiated: UBR_CONV_BN_ACT_SHAPES, from the one table
// in ops/_build.py:SHAPES.
UBR_EXPORT int ubr_conv_bn_act(const void* x, const void* w, const void* g,
                               const void* b, const void* res, void* out,
                               int B, int H, int W, int ci, int co, int k,
                               int pre_act, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define UBR_CONV(CI, CO, K)                                                \
  if (ci == CI && co == CO && k == K)                                      \
    return launch<CI, CO, K>(x, w, g, b, res, out, B, H, W, pre_act, act, s);
  UBR_CONV_BN_ACT_SHAPES(UBR_CONV)
#undef UBR_CONV
  return (int)cudaErrorInvalidValue;
}
