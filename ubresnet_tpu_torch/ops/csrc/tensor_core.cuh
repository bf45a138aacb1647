// Tensor-core helpers of the port's Hopper kernels (K1 conv_bn_act, K2
// basic_block, K3 deconv2x, K5 conv_stats, K6 conv_dw, K8 conv_s2k4, K9
// deconv_dw, and the int8 K1-s8 conv_bn_act_s8, K2-s8 basic_block_s8,
// K3-s8 deconv2x_s8):
// bf16 mma.sync m16n8k16 with f32 accumulators (and s8 m16n8k32 with
// s32 accumulators, below), A fragments by ldmatrix
// from pixel-major NHWC tiles in shared memory (one lane per pixel: the
// im2col gather over the taps is the lane's address; .trans where the
// pixels are the GEMM's K, as in a weight gradient), B fragments laid
// out per lane once per block, 16- and 8-byte cp.async copies with
// zero-fill, the chunk swizzle of the tiles, 16-byte stores of staged
// output rows, and the persistent grid's size.
//
// A tile of C channels holds NC = C / 8 16-byte chunks per pixel. An
// ldmatrix phase reads one chunk of 8 consecutive pixels; unswizzled,
// with a pixel stride of 32, 64 or 128 bytes those land in 2, 4 or 8
// pixels per 128-byte bank line and collide. chunk_at XORs the chunk
// index with the pixel's line bits so any 8 consecutive pixels hit 8
// distinct 16-byte bank groups (NC = 2, 4, 8 or 16; NC = 1 needs no
// swizzle: 8 consecutive pixels fill one bank line).
#pragma once

#include "common.cuh"

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte unit of chunk c of pixel p in a swizzled tile of NC chunks
// per pixel (multiply by 8 for a bf16 offset).
template <int NC>
__host__ __device__ constexpr int chunk_at(int p, int c) {
  static_assert(NC == 1 || NC == 2 || NC == 4 || NC == 8 || NC == 16,
                "tile chunks per pixel");
  // NC = 16 (a 256-byte pixel: bf16 128 channels, or 64 floats): the
  // same eight bank groups as NC = 8, in each 128-byte half
  return p * NC + (c ^ (NC >= 8 ? (p & 7) : ((p * NC >> 3) & (NC - 1))));
}

// Element offset of channel ch (even) of pixel p in such a tile of E
// elements a chunk: 8 bf16 (the default), 16 int8 or 4 float.
template <int NC, int E = 8>
__device__ __forceinline__ int elem_at(int p, int ch) {
  return chunk_at<NC>(p, ch / E) * E + ch % E;
}

// Byte offset of chunk 2 kc + half of pixel p in such a tile, as
// a_off(p, half) ^ (kc << 5): the XOR touches only the chunk bits of
// the offset (a multiple of 16 NC bytes plus the chunk), so one offset
// per lane, pixel and tap serves every k-step of that tap.
template <int NC>
__device__ __forceinline__ uint32_t a_off(int p, int half) {
  return 16u * (uint32_t)chunk_at<NC>(p, half);
}

// Lane l's A row (of 16) and chunk half for ldmatrix.x4: matrices
// 0..3 are (rows 0-7, k 0-7), (rows 8-15, k 0-7), (rows 0-7, k 8-15),
// (rows 8-15, k 8-15) — the mma A fragment's a0..a3.
__device__ __forceinline__ int a_row(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int a_half(int lane) { return lane >> 4; }

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same four 8x8 matrices transposed: lane l gets elements (rows
// 2(l%4), 2(l%4) + 1; column l/4) of each. Where a tile's pixels are a
// GEMM's K and its channels M or N (a weight gradient: rows of the
// stored matrix are pixels), this yields the mma A or B fragment.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two transposed matrices (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t addr,
                                              uint32_t (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// c += a · b over one m16n8k16 step (bf16 in, f32 accumulate). c0, c1:
// row lane/4, columns 2(lane%4) and +1; c2, c3: row lane/4 + 8.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a · b over one m16n8k16 step from a zero accumulator (C = RZ).
// Tensor cores add into C with truncation, which biases a long sum
// toward zero; a caller that adds d into its own f32 sum with FADDs
// (round to nearest) keeps that error to one k-step's partial.
__device__ __forceinline__ void mma_zc(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Channels of a tile that holds c real ones: c, or the next multiple
// of 16 (an 8-channel stream is zero-padded to one bf16 k-step, or one
// 16-byte int8 chunk; its padding's B rows or columns are zero).
__host__ __device__ constexpr int pad16(int c) { return (c + 15) / 16 * 16; }

// The K x N bf16 matrix val(k, n) as mma B fragments in shared memory:
// for k-step s (16 rows) and n-tile pair q (16 columns) lane l owns one
// uint4 at dst[(s * N/16 + q) * 32 + l], {b0, b1} of n-tile 2q then of
// n-tile 2q + 1, where b0 packs rows 16s + 2(l%4) and +1 of column l/4
// and b1 the same rows + 8. A warp then reads a k-step's B with one
// conflict-free 16-byte load per lane and n-tile pair. val gives zero
// where the kernel pads K or N. Written once per block.
template <int K, int N, typename Val>
__device__ __forceinline__ void stage_bv(uint4* dst, Val val, int tid,
                                         int nthreads) {
  static_assert(K % 16 == 0 && N % 16 == 0, "B is 16 x 16 steps");
  constexpr int NQ = N / 16;
  for (int e = tid; e < (K / 16) * NQ * 32; e += nthreads) {
    const int l = e & 31, q = (e >> 5) % NQ, s = (e >> 5) / NQ;
    const int k = s * 16 + 2 * (l & 3), n = q * 16 + (l >> 2);
    uint32_t v[4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        v[2 * h + r] = pack_bf16(val(k + 8 * r, n + 8 * h),
                                 val(k + 8 * r + 1, n + 8 * h));
    dst[e] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The same fragments one n-tile (8 columns) at a time, for any N that is
// a multiple of 8 and a K of KS 16-row steps: lane l owns one uint2 {b0,
// b1} at dst[(s * N/8 + t) * 32 + l]. val(k, n) gives element (k, n) as
// a bf16, zero where the kernel pads K or N (taps or channels beyond the
// real ones).
template <int KS, int N, typename Val>
__device__ __forceinline__ void stage_b8(uint2* dst, Val val, int tid,
                                         int nthreads) {
  static_assert(N % 8 == 0, "B is 16 x 8 steps");
  constexpr int NT8 = N / 8;
  for (int e = tid; e < KS * NT8 * 32; e += nthreads) {
    const int l = e & 31, t = (e >> 5) % NT8, s = (e >> 5) / NT8;
    const int k = s * 16 + 2 * (l & 3), n = t * 8 + (l >> 2);
    dst[e] = make_uint2(pack_bf16(val(k, n), val(k + 1, n)),
                        pack_bf16(val(k + 8, n), val(k + 9, n)));
  }
}

// NP staged pixels (pixel sp of a swizzled tile of NC chunks a pixel,
// bf16 or float) to the NHWC tensor out of CO channels, pixel sp at
// out pixel pix(sp) (negative: outside the image, skipped): whole
// 16-byte chunks where CO fills them, else (co = 3 or 4, a tile padded
// to 8 channels) element by element. Channels of the tile past CO are
// the kernel's padding and are never stored.
template <int NC, int CO, typename T, typename Pix>
__device__ __forceinline__ void store_staged(T* out, const T* st, int np,
                                             Pix pix, int lane) {
  constexpr int E = 16 / (int)sizeof(T);  // elements a chunk
  static_assert(CO <= NC * E, "the staged tile holds every channel");
  if constexpr (CO % E == 0) {
    constexpr int NCR = CO / E;  // real chunks a pixel
    for (int e = lane; e < np * NCR; e += 32) {
      const int sp = e / NCR, c = e % NCR;
      const long o = pix(sp);
      if (o >= 0)
        *reinterpret_cast<uint4*>(out + o * CO + c * E) =
            *reinterpret_cast<const uint4*>(st + chunk_at<NC>(sp, c) * E);
    }
  } else {
    for (int e = lane; e < np * CO; e += 32) {
      const int sp = e / CO, c = e % CO;
      const long o = pix(sp);
      if (o >= 0) out[o * CO + c] = st[chunk_at<NC>(sp, c / E) * E + c % E];
    }
  }
}

// A warp's R staged output rows of 16 pixels (staged pixel sp = r * 16 +
// px in a swizzled tile of NC chunks a pixel) to image n of the NHWC
// tensor out (H, W, CO channels: bf16 or float; CO defaults to the
// tile's NC whole chunks) at rows r0 .., columns c0 .., skipping pixels
// outside the image.
template <int NC, int R, int CO = 0, typename T>
__device__ __forceinline__ void store_rows(T* out, const T* st, int n,
                                           int r0, int c0, int H, int W,
                                           int lane) {
  constexpr int C = CO > 0 ? CO : NC * (16 / (int)sizeof(T));
  store_staged<NC, C>(
      out, st, R * 16,
      [=](int sp) -> long {
        const int oh = r0 + sp / 16, ow = c0 + sp % 16;
        return oh < H && ow < W ? ((long)n * H + oh) * W + ow : -1;
      },
      lane);
}

// ---- int8: s8 x s8 -> s32 on mma.sync m16n8k32, exact accumulators.
// An int8 tile of C channels holds NC = C / 16 chunks a pixel and a
// k-step is 32 channels, two chunks: the same bytes as a bf16 k-step of
// 16 channels. So A comes by the same ldsm_x4 at the same lane addresses
// (a_row, a_half, a_off, the k-step XOR): ldmatrix's b16 view of a
// 16-byte row gives lane l bytes 4(l%4) .. 4(l%4) + 3, the int8 channels
// of the s8 fragment's a0..a3 (rows lane/4 and + 8, k 4(l%4) .. and
// + 16), lowest channel in the lowest byte.

// c += a · b over one m16n8k32 step (s8 in, s32 accumulate); c as mma's.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows k .. k + 3 of column n of the int8 matrix val(k, n), row k in
// the lowest byte: one s8 B-fragment register.
template <typename Val>
__device__ __forceinline__ uint32_t s8_rows4(Val val, int k, int n) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (uint32_t)(uint8_t)val(k + i, n) << (8 * i);
  return w;
}

// The K x N int8 matrix val(k, n) as m16n8k32 B fragments in shared
// memory, for KS k-steps of 32 rows: for k-step s and n-tile pair q (16
// columns) lane l owns one uint4 at dst[(s * N/16 + q) * 32 + l], {b0,
// b1} of n-tile 2q then of n-tile 2q + 1, where b0 packs rows 32s +
// 4(l%4) .. + 3 of column l/4 (row k in byte k % 4) and b1 the same rows
// + 16. val gives zero where the kernel pads K (taps beyond the real
// ones). Written once per block.
template <int KS, int N, typename Val>
__device__ __forceinline__ void stage_b_s8(uint4* dst, Val val, int tid,
                                           int nthreads) {
  static_assert(N % 16 == 0, "B is 32 x 16 steps");
  constexpr int NQ = N / 16;
  for (int e = tid; e < KS * NQ * 32; e += nthreads) {
    const int l = e & 31, q = (e >> 5) % NQ, s = (e >> 5) / NQ;
    const int k = s * 32 + 4 * (l & 3), n = q * 16 + (l >> 2);
    dst[e] = make_uint4(s8_rows4(val, k, n), s8_rows4(val, k + 16, n),
                        s8_rows4(val, k, n + 8), s8_rows4(val, k + 16, n + 8));
  }
}

// The same fragments one n-tile (8 columns) at a time, as stage_b8 for
// bf16: lane l owns one uint2 {b0, b1} at dst[(s * N/8 + t) * 32 + l].
template <int KS, int N, typename Val>
__device__ __forceinline__ void stage_b8_s8(uint2* dst, Val val, int tid,
                                            int nthreads) {
  static_assert(N % 8 == 0, "B is 32 x 8 steps");
  constexpr int NT8 = N / 8;
  for (int e = tid; e < KS * NT8 * 32; e += nthreads) {
    const int l = e & 31, t = (e >> 5) % NT8, s = (e >> 5) / NT8;
    const int k = s * 32 + 4 * (l & 3), n = t * 8 + (l >> 2);
    dst[e] = make_uint2(s8_rows4(val, k, n), s8_rows4(val, k + 16, n));
  }
}

// 16 bytes global → shared, asynchronously; with valid false nothing
// is read (src-size 0) and the destination is zero-filled: the 'same'
// padding. src must still be a valid address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 8 bytes the same way (cp.async.ca: .cg copies only 16).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
// Chunk c (16 bytes) of a tile pixel whose source pixel src holds CB
// real bytes (a multiple of 8; more chunks than that are the tile's
// channel padding): a whole chunk, an 8-byte half and 8 zero bytes, or
// 16 zero bytes. With valid false (outside the image) the chunk is
// zeros. base, a 16-byte aligned address of the tensor, is the source
// named where nothing is read.
template <int CB>
__device__ __forceinline__ void cp_chunk(uint32_t dst, const void* base,
                                         const void* src, int c,
                                         bool valid) {
  static_assert(CB % 8 == 0, "pixels of whole 8-byte units");
  const char* p = static_cast<const char*>(src) + 16 * c;
  const int real = CB - 16 * c;
  if (real >= 16) {
    cp_async16(dst, valid ? p : base, valid);
  } else if (real == 8) {
    cp_async8(dst, valid ? p : base, valid);
    cp_async8(dst + 8, base, false);
  } else {
    cp_async16(dst, base, false);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait until at most N of this thread's newest cp.async groups are
// still in flight (every older group has landed).
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The dynamic shared memory one block may use on the H100 (227 KB).
constexpr int SMEM_MAX = 232448;

// Blocks of SMEM dynamic shared bytes that fit on one SM (228 KB, 1 KB
// of it reserved per block), at most CAP: the kernel's minimum blocks
// per SM for __launch_bounds__, so registers do not cap occupancy below
// what shared memory allows.
template <int SMEM, int CAP>
__host__ __device__ constexpr int blocks_per_sm() {
  return (233472 / (SMEM + 1024)) < CAP ? (233472 / (SMEM + 1024)) : CAP;
}

// Blocks of a kernel that fit on the card at once: SM count × blocks
// per SM at this shared-memory size, the most a persistent launch
// takes. Fixed for a kernel instance and device, so it is asked once:
// the caller keeps *most in a static (0 until the first call), as
// allow_smem's flag. The kernel's dynamic shared-memory limit must
// already be raised (allow_smem).
template <typename Kernel>
static cudaError_t resident_blocks(Kernel kernel, int threads, int smem,
                                   int* most) {
  if (*most > 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *most = sms * per_sm;
  return cudaSuccess;
}

}  // namespace tc
