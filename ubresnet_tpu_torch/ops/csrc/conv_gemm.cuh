// The stride-1, odd k x k 'same' convolution as a tensor-core implicit
// GEMM over one 16x16 output tile, the mainloop of K1 conv_bn_act and of
// K5 conv_stats (bf16) and of K1-s8 conv_bn_act_s8 (int8), each with its
// own epilogue:
//   M = the tile's 256 output pixels, 16 per M-tile (one tile row),
//   N = co, padded to a multiple of 8 (co = 3: columns 3-7 are zero),
//   K = taps x channels, tap-major, in k-steps of 32 bytes: 16 bf16
//       channels on mma.sync m16n8k16 with f32 accumulators, or (Shape's
//       T = int8_t) 32 int8 channels on m16n8k32 with exact s32 ones.
// A fragments come by ldmatrix straight from the pixel-major x tile in
// shared memory (the (16+k-1)^2 haloed input, zero outside the image):
// each lane gives its pixel's 16-byte chunk at the tap's offset, so the
// im2col gather is the lane's address. An int8 k-step is a bf16 k-step's
// bytes, so both types share the lane addresses. The weights are laid
// out once per block as per-lane B fragments (tc::stage_b8, or
// tc::stage_b8_s8).
//
// A tile pixel of one 16-byte chunk (bf16 ci = 4, int8 ci = 16) does not
// fill a k-step with one tap. A k-step then covers two taps: lanes 0-15
// address the first tap's pixel, lanes 16-31 the second's (the A
// fragment's first and second 16 bytes of K), and the B rows of the
// phantom 50th tap are zero; the phantom's lanes read the last real
// tap's pixel, so every ldmatrix address stays inside the tile. bf16
// ci = 8 is such a pixel as it stands. A pixel of 8 bytes (bf16 ci = 4,
// int8 ci = 8) is zero-padded to one chunk (channels 4-7, or 8-15,
// zero, written once, their B rows zero): two times the real MACs,
// against four with the tile zero-padded to a whole k-step; its 8-byte
// pixels are copied with 8-byte cp.async.
//
// co that is no multiple of 8 (3 or 4) pads N to 8: the B columns past
// co are zero and the epilogues store only the real channels.
#pragma once

#include <type_traits>

#include "tensor_core.cuh"

namespace cg {

constexpr int TH = 16, TW = 16;

template <int CI, int CO, int K, typename T = bf16>
struct Shape {
  using Elem = T;                                  // bf16 or int8_t
  static constexpr int CI_ = CI;                   // real channels of x
  static constexpr bool S8 = sizeof(T) == 1;
  using Acc = typename std::conditional<S8, int, float>::type;
  // 8-byte pixels (bf16 ci = 4, int8 ci = 8) in 16-byte tile pixels
  static constexpr bool PAD8 = CI * (int)sizeof(T) == 8;
  static constexpr int KSIZE = K, R = K / 2, TAPS = K * K;
  static constexpr int XH = TH + K - 1, XW = TW + K - 1;
  static constexpr int E = 16 / (int)sizeof(T);  // channels a 16-byte chunk
  static constexpr int CT = PAD8 ? E : CI;       // channels a tile pixel
  static constexpr int NC = CT / E;              // 16-byte chunks a pixel
  static constexpr int KC = CT / (2 * E);        // k-steps a tap (NC >= 2)
  static constexpr int KSTEPS = NC >= 2 ? TAPS * KC : (TAPS + 1) / 2;
  static constexpr int COP = (CO + 7) / 8 * 8;  // padded N
  static constexpr int NT8 = COP / 8;           // n-tiles of 8
  static constexpr int B_UNITS = KSTEPS * NT8 * 32;  // uint2 of B fragments
  static constexpr int X_ELEMS = XH * XW * CT;       // T of one x tile
  static_assert(CI * (int)sizeof(T) == 8 || CI * (int)sizeof(T) == 16 ||
                    CI % (2 * E) == 0,
                "ci: bf16 4, 8 or a multiple of 16; int8 8, 16 or a "
                "multiple of 32");
};

// The (k, k, ci, co) weight as B fragments (S::B_UNITS uint2). Padded
// K row kp is tap kp / CT, channel kp % CT; zero past the last tap, the
// last channel or the last column.
template <class S>
__device__ __forceinline__ void stage_w(uint2* dst,
                                        const typename S::Elem* w, int ci,
                                        int co, int tid, int nthreads) {
  auto at = [=](int kp, int n) {  // w's index, or -1 where K or N is padded
    const int tap = kp / S::CT, c = kp % S::CT;
    return tap < S::TAPS && c < ci && n < co ? (tap * ci + c) * co + n : -1;
  };
  if constexpr (S::S8) {
    tc::stage_b8_s8<S::KSTEPS, S::COP>(
        dst,
        [=](int kp, int n) {
          const int i = at(kp, n);
          return i < 0 ? 0 : (int)w[i];
        },
        tid, nthreads);
  } else {
    tc::stage_b8<S::KSTEPS, S::COP>(
        dst,
        [=](int kp, int n) {
          const int i = at(kp, n);
          return i < 0 ? __float2bfloat16(0.f) : w[i];
        },
        tid, nthreads);
  }
}

// Zero the padded second half of every pixel of nbuf x tiles (8-byte
// pixels only; the copies never touch it).
template <class S>
__device__ __forceinline__ void zero_pad(typename S::Elem* xs, int nbuf,
                                         int tid, int nthreads) {
  if constexpr (S::PAD8) {
    for (int p = tid; p < nbuf * S::XH * S::XW; p += nthreads)
      *reinterpret_cast<uint2*>(xs + p * S::E + S::E / 2) =
          make_uint2(0u, 0u);
  }
}

// Start the copy of the x tile of image n whose output tile has its
// top-left pixel at (oh0, ow0): rows oh0 - R .., zero outside the image.
template <class S>
__device__ __forceinline__ void load_x(typename S::Elem* dst,
                                       const typename S::Elem* __restrict__ x,
                                       int n, int oh0, int ow0, int H, int W,
                                       int tid, int nthreads) {
  const int y0 = oh0 - S::R, x0 = ow0 - S::R;
  if constexpr (S::PAD8) {  // 8 bytes into a 16-byte pixel
    for (int p = tid; p < S::XH * S::XW; p += nthreads) {
      const int ih = y0 + p / S::XW, iw = x0 + p % S::XW;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const long pix = in ? ((long)n * H + ih) * W + iw : 0;
      tc::cp_async8(tc::smem_u32(dst + p * S::E), x + pix * S::CI_, in);
    }
  } else {
    for (int e = tid; e < S::XH * S::XW * S::NC; e += nthreads) {
      const int p = e / S::NC, c = e % S::NC;
      const int ih = y0 + p / S::XW, iw = x0 + p % S::XW;
      const bool in = ih >= 0 && ih < H && iw >= 0 && iw < W;
      const long pix = in ? ((long)n * H + ih) * W + iw : 0;
      tc::cp_async16(tc::smem_u32(dst + tc::chunk_at<S::NC>(p, c) * S::E),
                     x + pix * S::CT + c * S::E, in);
    }
  }
  tc::cp_async_commit();
}

template <class S, int J, typename A>
__device__ __forceinline__ void zero_acc(A (&acc)[J][S::NT8][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int t = 0; t < S::NT8; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][t][i] = 0;
}

// acc[j] += the conv over output row row[j] of the tile in x tile xt
// (shared address) with B fragments wf. acc[j][t] is the mma C fragment
// of n-tile t: c0, c1 pixel lane/4 of the row, channels 8t + 2(lane%4)
// and +1; c2, c3 pixel lane/4 + 8. PROMOTE: each k-step's product comes
// from a zero accumulator and is added into acc with f32 FADDs (round to
// nearest), so the tensor cores' truncating accumulation does not bias
// the sum over a long K (K5, whose bf16 y feeds BatchNorm's statistics).
// int8 (S::S8): the same fragments on m16n8k32 into exact s32 sums.
template <class S, int J, bool PROMOTE = false>
__device__ __forceinline__ void conv_rows(typename S::Acc (&acc)[J][S::NT8][4],
                                          uint32_t xt, const uint2* wf,
                                          const int (&row)[J], int lane) {
  static_assert(!(S::S8 && PROMOTE), "s32 sums are exact: nothing to promote");
  constexpr int K = S::KSIZE;
  const int ar = tc::a_row(lane), half = tc::a_half(lane);
  int base[J];
#pragma unroll
  for (int j = 0; j < J; ++j) base[j] = row[j] * S::XW + ar;

  auto step = [&](int s, const uint32_t (&off)[J]) {
    uint2 b[S::NT8];
#pragma unroll
    for (int t = 0; t < S::NT8; ++t) b[t] = wf[(s * S::NT8 + t) * 32 + lane];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      uint32_t a[4];
      tc::ldsm_x4(xt + off[j], a);
#pragma unroll
      for (int t = 0; t < S::NT8; ++t) {
        if constexpr (S::S8) {
          tc::mma_s8(acc[j][t], a, b[t].x, b[t].y);
        } else if constexpr (PROMOTE) {
          float d[4];
          tc::mma_zc(d, a, b[t].x, b[t].y);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][t][i] += d[i];
        } else {
          tc::mma(acc[j][t], a, b[t].x, b[t].y);
        }
      }
    }
  };

  if constexpr (S::NC >= 2) {
    // one tap a KC k-steps; lane's chunk 2 kc + half, kc by XOR
#pragma unroll 1
    for (int kh = 0; kh < K; ++kh) {
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        uint32_t off0[J];
#pragma unroll
        for (int j = 0; j < J; ++j)
          off0[j] = tc::a_off<S::NC>(base[j] + kh * S::XW + kw, half);
#pragma unroll
        for (int kc = 0; kc < S::KC; ++kc) {
          uint32_t off[J];
#pragma unroll
          for (int j = 0; j < J; ++j) off[j] = off0[j] ^ (kc << 5);
          step((kh * K + kw) * S::KC + kc, off);
        }
      }
    }
  } else {
    // two taps a k-step: lanes 16-31 on the second (the last step's
    // second tap is a phantom with zero B rows: it reads tap TAPS - 1)
#pragma unroll 5
    for (int s = 0; s < S::KSTEPS; ++s) {
      const int tap = min(2 * s + half, S::TAPS - 1);
      uint32_t off[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        off[j] = 16u * (uint32_t)(base[j] + (tap / K) * S::XW + tap % K);
      step(s, off);
    }
  }
}

}  // namespace cg
