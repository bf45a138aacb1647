// K5 conv_stats — the train zone's convolution with its batch
// statistics: stride-1, odd k x k 'same' convolution over an NHWC bf16
// tensor, f32 accumulation, + bias when given, stored as bf16 y, and
// per channel s1 = sum(y) and s2 = sum(y * y) over every pixel of the
// batch, taken on the stored bf16 values (f32 sums). No affine and no
// ReLU: train-mode BatchNorm needs the raw conv output and normalises
// from (s1, s2) alone.
//
// Replaces ubresnet_tpu/ops/pallas_train.py:train_conv_stats
// (_conv_stats_kernel), which accumulates the sums in VMEM across its
// sequential grid. The TPU kernel's W-packing and halo-combo blocks are
// not carried over.
//
// Bound on the H100 at the bf16 tensor-core rate: operations for the
// head's 7x7 (49*16*16 MACs per 64 bytes of a pixel's input and output:
// 392 op/B, above the ~295 op/B ridge), bytes for the 3x3 layers (144-192
// op/B) and the 1x1 projections.
//
// Design (tensor cores): K1's mainloop (conv_gemm.cuh: M = a 16x16
// output tile's pixels, N = co, K = taps x ci tap-major, bf16 mma.sync
// m16n8k16 with f32 accumulators) with its own epilogue:
// - each k-step's MMA starts from a zero accumulator and is added into
//   the f32 sum by FADDs (conv_rows' PROMOTE): the tensor cores' own
//   accumulation truncates, and over K = 9 ci or 49 ci its bias toward
//   zero moves y's channel means enough for BatchNorm's statistics to
//   carry it into the train loss;
// - a persistent grid (SMs x blocks per SM, asked once per kernel
//   instance, at most the wrapper's scratch rows) walks tiles
//   t = blockIdx.x + i * gridDim.x; each block lays the weights out once
//   as B fragments; the next tile's haloed x arrives by double-buffered
//   cp.async (zero-filled outside the image); 8 warps, two output rows
//   each;
// - the epilogue adds the bias, rounds to bf16 and stages the tile's
//   rows per warp for 16-byte coalesced stores; from the ROUNDED value
//   each lane adds y and y*y of its in-image pixels into registers for
//   its channels 8t + 2(lane%4) and +1 (rows past the image hold
//   bias-only values and are left out);
// - deterministic sums without atomics: at the end of the block the
//   lane sums meet over the 8 lanes that share a channel (shuffles in a
//   fixed order), then over the 8 warps in order, into the block's own
//   row of the scratch; sum_rows (partials.cuh) adds the rows in order.
//   Same inputs and grid, same bits in y, s1 and s2 on every launch.
// 8-channel streams (inplanes 8 and 4): ci = 8 takes two taps a k-step
// (conv_gemm.cuh); co = 4 pads N to 8 with zero B columns and biases,
// whose y stays zero and is never stored nor summed.
#include "conv_gemm.cuh"
#include "partials.cuh"
#include "ubr_shapes.h"  // UBR_CONV_STATS_SHAPES (ops/_build.py:SHAPES)

namespace {

constexpr int NWARP = 8, NT = 32 * NWARP;
constexpr int J = cg::TH / NWARP;  // output rows a warp

template <int CI, int CO, int K>
struct StatsShape : cg::Shape<CI, CO, K> {
  using G = cg::Shape<CI, CO, K>;
  static constexpr int NCO = G::COP / 8;          // staging chunks a pixel
  static constexpr int ST = J * cg::TW * G::COP;  // staging bf16 a warp
  static constexpr int SMEM = G::B_UNITS * 8 + G::COP * 4 +
                              (2 * G::X_ELEMS + NWARP * ST) * 2;
  // registers: J x co / 2 accumulators and co / 2 sums a thread (at
  // co = 64, 96 of them: one block an SM)
  static constexpr int CAP = CO <= 16 ? 3 : (CO <= 32 ? 2 : 1);
  static_assert(NWARP * 2 * CO * 4 <= 2 * G::X_ELEMS * 2,
                "block sums fit the x tiles");
};

template <int CI, int CO, int K>
__global__ void __launch_bounds__(
    NT, (tc::blocks_per_sm<StatsShape<CI, CO, K>::SMEM,
                           StatsShape<CI, CO, K>::CAP>()))
conv_stats_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ bias, bf16* __restrict__ y,
                  float* __restrict__ part, int B, int H, int W) {
  using S = StatsShape<CI, CO, K>;
  constexpr int NT8 = S::NT8, NCO = S::NCO;
  extern __shared__ uint4 smem[];
  uint2* wf = reinterpret_cast<uint2*>(smem);
  float* bs = reinterpret_cast<float*>(wf + S::B_UNITS);  // bias
  bf16* xs = reinterpret_cast<bf16*>(bs + S::COP);
  bf16* st = xs + 2 * S::X_ELEMS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q4 = lane & 3;
  const int tiles_x = (W + cg::TW - 1) / cg::TW;
  const int tiles_y = (H + cg::TH - 1) / cg::TH;
  const int per_img = tiles_x * tiles_y, ntiles = B * per_img;

  cg::stage_w<S>(wf, w, CI, CO, tid, NT);
  for (int e = tid; e < S::COP; e += NT)
    bs[e] = bias != nullptr && e < CO ? bias[e] : 0.f;

  auto load = [&](int t, bf16* dst) {
    const int n = t / per_img, r = t % per_img;
    cg::load_x<S>(dst, x, n, (r / tiles_x) * cg::TH, (r % tiles_x) * cg::TW,
                  H, W, tid, NT);
  };

  int row[J];
#pragma unroll
  for (int j = 0; j < J; ++j) row[j] = warp * J + j;
  bf16* wst = st + warp * S::ST;  // this warp's staging

  // sums of this lane's channels 8 t + 2 q4 + e over its pixels
  float s1[NT8][2], s2[NT8][2];
#pragma unroll
  for (int t = 0; t < NT8; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) s1[t][e] = s2[t][e] = 0.f;

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
    cg::conv_rows<S, J, true>(acc, tc::smem_u32(xs + buf * S::X_ELEMS), wf,
                              row, lane);

    // epilogue -> this warp's staging (pixel sp = j * TW + px) and sums
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int oh = oh0 + row[j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = gq + 8 * h;
        const bool in = oh < H && ow0 + px < W;
#pragma unroll
        for (int tt = 0; tt < NT8; ++tt) {
          const int ch = tt * 8 + 2 * q4;
          const bf162 q = __floats2bfloat162_rn(
              acc[j][tt][2 * h] + bs[ch], acc[j][tt][2 * h + 1] + bs[ch + 1]);
          *reinterpret_cast<bf162*>(
              wst + tc::elem_at<NCO>(j * cg::TW + px, ch)) = q;
          if (in) {  // sums of the emitted values
            const float2 f = __bfloat1622float2(q);
            s1[tt][0] += f.x;
            s1[tt][1] += f.y;
            s2[tt][0] = fmaf(f.x, f.x, s2[tt][0]);
            s2[tt][1] = fmaf(f.y, f.y, s2[tt][1]);
          }
        }
      }
    }
    __syncwarp();
    tc::store_rows<NCO, J, CO>(y, wst, n, oh0 + warp * J, ow0, H, W, lane);
    __syncwarp();  // staging read before the next tile's epilogue
  }

  // block sums: the 8 lanes of a channel (lane / 4 = 0..7) in a fixed
  // tree, then the warps in order. No copy is in flight after the last
  // tile, so the x tiles take the per-warp sums once every warp is done.
  __syncthreads();
  float* red = reinterpret_cast<float*>(xs);  // [warp][s1 | s2][co]
#pragma unroll
  for (int tt = 0; tt < NT8; ++tt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = s1[tt][e], q = s2[tt][e];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      const int ch = tt * 8 + 2 * q4 + e;
      if (gq == 0 && ch < CO) {
        red[warp * 2 * CO + ch] = a;
        red[warp * 2 * CO + CO + ch] = q;
      }
    }
  __syncthreads();
  if (tid < 2 * CO) {
    float s = 0.f;
    for (int wp = 0; wp < NWARP; ++wp) s += red[wp * 2 * CO + tid];
    part[(long)blockIdx.x * 2 * CO + tid] = s;
  }
}

template <int CI, int CO, int K>
int launch(const void* x, const void* w, const void* bias, void* y,
           void* part, void* sums, int B, int H, int W, int blocks,
           cudaStream_t stream) {
  using S = StatsShape<CI, CO, K>;
  static bool smem_set = false;
  static int most = 0;
  cudaError_t e = allow_smem(conv_stats_kernel<CI, CO, K>, S::SMEM, &smem_set);
  if (e == cudaSuccess)
    e = tc::resident_blocks(conv_stats_kernel<CI, CO, K>, NT, S::SMEM, &most);
  if (e != cudaSuccess) return (int)e;
  const int grid = blocks < most ? blocks : most;
  conv_stats_kernel<CI, CO, K><<<grid, NT, S::SMEM, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y),
      static_cast<float*>(part), B, H, W);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(static_cast<const float*>(part), grid, 2 * CO, 1.f,
                       static_cast<float*>(sums), stream);
}

}  // namespace

// (ci, co, k) instantiated: UBR_CONV_STATS_SHAPES, from the one table in
// ops/_build.py:SHAPES. sums is (2*co,) f32: s1 then s2; part is the
// wrapper's (blocks, 2*co) f32 scratch, blocks at most the 16x16 tiles;
// the kernel runs min(blocks, resident blocks) blocks and adds that many
// rows.
UBR_EXPORT int ubr_conv_stats(const void* x, const void* w, const void* bias,
                              void* y, void* part, void* sums, int B, int H,
                              int W, int ci, int co, int k, int blocks,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks < 1) return (int)cudaErrorInvalidValue;
#define UBR_STATS(CI, CO, K)                                               \
  if (ci == CI && co == CO && k == K)                                      \
    return launch<CI, CO, K>(x, w, bias, y, part, sums, B, H, W, blocks, s);
  UBR_CONV_STATS_SHAPES(UBR_STATS)
#undef UBR_STATS
  return (int)cudaErrorInvalidValue;
}
