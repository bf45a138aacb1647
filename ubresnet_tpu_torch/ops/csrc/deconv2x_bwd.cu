// K10 deconv2x_bwd — the backward of ConvTranspose2d(k=4, stride=2,
// padding=1) in one launch: from x (B, H, W, ci), dy (B, 2H, 2W, co) and
// w (4, 4, ci, co), all bf16 NHWC, with f32 accumulation,
//   dx[b, i, j, ci]    = sum over kr, kc, co of w[kr, kc, ci, co] * dy[.]
//   dW[kr, kc, ci, co] = sum over b, i, j of x[b, i, j, ci] * dy[.]
// dy[.] = dy[b, 2i + kr - 1, 2j + kc - 1, co], zero outside dy; dx bf16,
// dW f32 in the deconv's (4, 4, ci, co) layout.
//
// Replaces the backward of ubresnet_tpu/ops/pallas_conv.py:
// pallas_deconv2x_ad (_deconv_ad_bwd: fused_conv_s2k4 for dx,
// pallas_deconv_dw for dW), which K8 (conv_s2k4.cu) and K9 (deconv_dw.cu)
// also compute, one leg and one read of dy each.
//
// Bound on the H100: bytes. Per x pixel 2 x 16 x ci x co MACs against one
// x pixel and four dy pixels read and one dx pixel written: 2·2·16·64·32 /
// (128 + 4·64 + 128) = 256 operations per byte at dec2 (64, 32), 128 at
// dec1 (32, 16), below the ~295 op/B bf16 tensor-core ridge. K8 and K9
// back to back read dy twice: 1.5x these bytes.
//
// Design: K8's and K9's GEMMs on one tile walk (parity_tiles.cuh).
// - A persistent grid walks x-side tiles (8x16 pixels at dec2, 16x16
//   below); each tile's x and its haloed dy window, as four parity
//   planes, arrive together by double-buffered 16-byte cp.async. dy and x
//   are read once.
// - The same 8 warps run both GEMMs from shared memory, dx (pt::Dx, K8's:
//   J dx rows a warp, the weights' B fragments laid out once per block)
//   then dW (pt::Dw, K9's: two taps a warp, the block's share of dW in
//   registers across its tiles). At dec2 a lane holds 128 dW sums for the
//   whole walk and 32 dx sums within a tile. Specialised warps would need
//   more registers, not fewer: dW alone takes 128 f32 a lane on 8 warps
//   (256 on 4), and a block of 16 warps may keep only 128 registers a
//   thread. So every warp does both, one block per SM at dec2 and dec1
//   (weights 64 KB / 16 KB, two buffers of x and planes 109 KB / 104 KB,
//   dx staging 16 KB: 189 KB and 136 KB), two at the 8-channel instances
//   (104 KB and 96 KB). Measured against K8 + K9 back to back on the same
//   tensors (PERF.md, rows 12-K10).
// - dW across blocks in a fixed order, in the same launch, no atomics on
//   dW: the grid is clusters of 8 blocks. After its walk each block puts
//   its share in its own shared memory; rank r of a cluster adds slice r
//   of the 8 shares in rank order through distributed shared memory and
//   writes it to the cluster's row of the scratch tensor (one row a
//   cluster, not one a block: an eighth of K9's scratch traffic); the
//   cluster that finishes last — a counter, the one atomic, which wraps
//   back to 0 for the next launch — adds the rows in cluster order into
//   dW, each rank its slice. Block b walks tiles b, b + gridDim.x, .. and
//   the grid is fixed per instance and device, so dW is the same bits on
//   every run.
// - 8-channel streams ((16, 8), (8, 4)): x pads to one 16-channel M-tile,
//   dy's planes to one 16-channel k-step (K8's planes, which K9's B reads
//   chunk 0 of), their padding never stored.
#include <cooperative_groups.h>

#include "parity_tiles.cuh"  // the tile walk, planes and both GEMMs
#include "ubr_shapes.h"  // UBR_DECONV2X_BWD_SHAPES (ops/_build.py:SHAPES)

namespace coop = cooperative_groups;

namespace {

using pt::NT;

constexpr int CLUSTER = 8;  // blocks a cluster

template <int CI, int CO>
struct BwdShape {
  static constexpr int QH = pt::tile_rows<CI, CO>();  // x-side tile rows
  using DX = pt::Dx<CI, CO, QH>;
  using DW = pt::Dw<CI, CO, QH, DX::NC>;  // on K8's planes
  static constexpr int X_ELEMS = QH * pt::QW * DW::CIP;  // bf16 of x tile
  static constexpr int BUF = X_ELEMS + 4 * DX::PLANE;    // bf16 of a buffer
  static constexpr int SMEM =
      DX::B_UNITS * 8 + (2 * BUF + pt::NWARP * DX::ST) * 2;
  static constexpr int T = DW::T;              // dW elements
  static constexpr int SLICE = T / CLUSTER;    // a rank's share of them
  static_assert(DW::PLANE == DX::PLANE, "one plane layout for both GEMMs");
  static_assert(T * 4 <= SMEM, "a block's dW share fits its shared memory");
  static_assert(SLICE % 4 == 0, "float4 slices");
  static_assert(X_ELEMS * 2 % 16 == 0 && BUF * 2 % 16 == 0,
                "16-byte aligned tiles");
};

template <int CI, int CO>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(
    NT, (tc::blocks_per_sm<BwdShape<CI, CO>::SMEM, 2>()))
deconv2x_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    const bf16* __restrict__ w, bf16* __restrict__ dx,
                    float* __restrict__ part, unsigned* __restrict__ done,
                    float* __restrict__ dw, int B, int H, int W) {
  using S = BwdShape<CI, CO>;
  using DX = typename S::DX;
  using DW = typename S::DW;
  extern __shared__ uint4 smem[];
  __shared__ int last;  // this cluster finished last (set by rank 0)
  uint2* wf = reinterpret_cast<uint2*>(smem);
  bf16* bufs = reinterpret_cast<bf16*>(wf + DX::B_UNITS);  // two buffers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* wst = bufs + 2 * S::BUF + warp * DX::ST;  // this warp's staging
  const pt::Walk<S::QH> walk(B, H, W);
  const typename DW::Lane ln(warp, lane);

  typename DW::Acc acc;
  DW::zero(acc);
  DX::stage_w(wf, w, tid);
  walk.run(
      [&](int t, int buf) {
        int n, i0, j0;
        walk.at(t, n, i0, j0);
        bf16* dst = bufs + buf * S::BUF;
        pt::load_x<CI, DW::CIP, S::QH>(dst, x, n, i0, j0, H, W, tid);
        pt::load_planes<CO, DX::COP, S::QH>(dst + S::X_ELEMS, dy, n, i0, j0,
                                            2 * H, 2 * W, tid);
        tc::cp_async_commit();
      },
      [&](int t, int buf) {
        int n, i0, j0;
        walk.at(t, n, i0, j0);
        const uint32_t xt = tc::smem_u32(bufs + buf * S::BUF);
        const uint32_t yt = xt + S::X_ELEMS * 2;
        DX::tile(dx, yt, wf, wst, n, i0, j0, H, W, warp, lane);
        DW::tile(acc, xt, yt, ln);
      });

  // dW: the block's share into its shared memory, the cluster's shares
  // added rank by rank into its row, the rows cluster by cluster into dw
  coop::cluster_group cluster = coop::this_cluster();
  float* share = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with the weights and the buffers
  DW::store(acc, share, warp, lane);
  cluster.sync();  // every rank's share is in place
  const int rank = (int)cluster.block_rank();
  const int clusters = (int)gridDim.x / CLUSTER;
  const int c0 = rank * S::SLICE;
  float* row = part + (long)(blockIdx.x / CLUSTER) * S::T;
  for (int e = 4 * tid; e < S::SLICE; e += 4 * NT) {
    float4 s = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(share + c0 + e, 0));
#pragma unroll
    for (int r = 1; r < CLUSTER; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(share + c0 + e, r));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(row + c0 + e) = s;
  }
  __threadfence();  // this thread's part of the row is visible on the card
  cluster.sync();   // the row is written; no rank reads a share any more
  if (rank == 0 && tid == 0) {
    const bool fin =
        atomicInc(done, (unsigned)(clusters - 1)) == (unsigned)(clusters - 1);
    for (int r = 0; r < CLUSTER; ++r) *cluster.map_shared_rank(&last, r) = fin;
  }
  cluster.sync();
  if (last) {
    __threadfence();
    for (int e = 4 * tid; e < S::SLICE; e += 4 * NT) {
      float4 s = __ldcg(reinterpret_cast<const float4*>(part + c0 + e));
      for (int c = 1; c < clusters; ++c) {
        const float4 v = __ldcg(
            reinterpret_cast<const float4*>(part + (long)c * S::T + c0 + e));
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      *reinterpret_cast<float4*>(dw + c0 + e) = s;
    }
  }
}

// The clusters of an instance that fit on the card at once, the most its
// persistent grid takes: asked once per instance (the kernel's
// shared-memory limit raised first), as tc::resident_blocks.
template <int CI, int CO>
cudaError_t resident_clusters(int* clusters) {
  using S = BwdShape<CI, CO>;
  static bool smem_set = false;
  static int most = 0;
  cudaError_t e = allow_smem(deconv2x_bwd_kernel<CI, CO>, S::SMEM, &smem_set);
  if (e == cudaSuccess && most == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = S::SMEM;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(
        &n, (const void*)deconv2x_bwd_kernel<CI, CO>, &cfg);
    if (e == cudaSuccess && n < 1) e = cudaErrorInvalidConfiguration;
    if (e == cudaSuccess) most = n;
  }
  *clusters = most;
  return e;
}

template <int CI, int CO>
int launch(const void* x, const void* dy, const void* w, void* dx, void* part,
           void* done, void* dw, int B, int H, int W, int rows,
           cudaStream_t stream) {
  using S = BwdShape<CI, CO>;
  int most = 0;
  cudaError_t e = resident_clusters<CI, CO>(&most);
  if (e != cudaSuccess) return (int)e;
  const long tiles = (long)B * ((H + S::QH - 1) / S::QH) *
                     ((W + pt::QW - 1) / pt::QW);
  if (tiles == 0)  // no pixels: dx is empty and dW zero
    return (int)cudaMemsetAsync(dw, 0, S::T * sizeof(float), stream);
  long clusters = (tiles + CLUSTER - 1) / CLUSTER;
  if (clusters > most) clusters = most;
  if (clusters > rows) clusters = rows;
  deconv2x_bwd_kernel<CI, CO><<<(int)clusters * CLUSTER, NT, S::SMEM,
                                stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(w), static_cast<bf16*>(dx),
      static_cast<float*>(part), static_cast<unsigned*>(done),
      static_cast<float*>(dw), B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// (ci, co) of the deconv instantiated: UBR_DECONV2X_BWD_SHAPES, from the
// one table in ops/_build.py:SHAPES. H, W are x's (the deconv's input
// side); x and dy must be 16-byte aligned. part is the wrapper's (rows,
// 16*ci*co) f32 scratch: the kernel runs min(rows, resident clusters)
// clusters of 8 blocks and writes and adds that many rows. done is one
// unsigned int, 0 before the first launch, which every launch leaves at
// 0; launches that share part and done run one after another (one
// stream). dx is (B, H, W, ci) bf16, dw (4, 4, ci, co) f32.
UBR_EXPORT int ubr_deconv2x_bwd(const void* x, const void* dy, const void* w,
                                void* dx, void* part, void* done, void* dw,
                                int B, int H, int W, int ci, int co, int rows,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1) return (int)cudaErrorInvalidValue;
#define UBR_BWD(CI, CO)                                                   \
  if (ci == CI && co == CO)                                               \
    return launch<CI, CO>(x, dy, w, dx, part, done, dw, B, H, W, rows, s);
  UBR_DECONV2X_BWD_SHAPES(UBR_BWD)
#undef UBR_BWD
  return (int)cudaErrorInvalidValue;
}
