// K7 weighted_nll and weighted_nll_bwd — the training loss, pixel-
// weighted negative log-likelihood from raw logits, and its gradient:
//   loss       = sum over pixels of w * (m + log sum_c exp(l_c - m) - l_label) / N
//   d loss/d l = (softmax(l) - onehot(label)) * w * g / N
// over NHWC f32 logits (C contiguous floats per pixel), int32 labels
// and f32 weights, N pixels.
//
// Replaces ubresnet_tpu/ops/pallas_loss.py:pallas_weighted_nll
// (_fwd_kernel, _bwd_kernel). The TPU kernel moves the class axis off
// the lane dimension and carries one scalar across its sequential
// grid; here each thread walks pixels with a grid stride, each block
// sums its threads (warp trees, then the warps in order) into its own
// scratch slot, and sum_rows (partials.cuh) adds the slots in order and
// divides by N: the same bits on every run.
//
// Bound on the H100: bytes (20 bytes read per pixel for C = 3 against
// a few exp/log; the backward also writes 12). Design: one thread per
// pixel per stride step, the pixel's C logits read as consecutive
// floats (neighbouring threads, neighbouring 12-byte records).
#include "common.cuh"
#include "partials.cuh"

namespace {

constexpr int NTH = 256, MAXC = 16;

__global__ void __launch_bounds__(NTH)
nll_fwd_kernel(const float* __restrict__ logits,
               const int* __restrict__ labels,
               const float* __restrict__ weights, float* __restrict__ part,
               long N, int C) {
  __shared__ float red[NTH / 32];
  float acc = 0.f;
  for (long i = (long)blockIdx.x * NTH + threadIdx.x; i < N;
       i += (long)gridDim.x * NTH) {
    const float* l = logits + i * C;
    const int lab = labels[i];
    float m = l[0];
    for (int c = 1; c < C; ++c) m = fmaxf(m, l[c]);
    float s = 0.f, tgt = 0.f;
    for (int c = 0; c < C; ++c) {
      s += expf(l[c] - m);
      if (c == lab) tgt = l[c];
    }
    acc += (m + logf(s) - tgt) * weights[i];
  }
  const float v = warp_sum(acc);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int wp = 0; wp < NTH / 32; ++wp) t += red[wp];
    part[blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(NTH)
nll_bwd_kernel(const float* __restrict__ logits,
               const int* __restrict__ labels,
               const float* __restrict__ weights, const float* __restrict__ g,
               float* __restrict__ grad, long N, int C, float n) {
  const long i = (long)blockIdx.x * NTH + threadIdx.x;
  if (i >= N) return;
  const float scale = __ldg(g) / n;
  const float* l = logits + i * C;
  const int lab = labels[i];
  float m = l[0];
  for (int c = 1; c < C; ++c) m = fmaxf(m, l[c]);
  float s = 0.f;
  for (int c = 0; c < C; ++c) s += expf(l[c] - m);
  const float lse = m + logf(s);
  const float w = weights[i];
  for (int c = 0; c < C; ++c) {
    const float p = expf(l[c] - lse);
    grad[i * C + c] = ((p - (c == lab ? 1.f : 0.f)) * w) * scale;
  }
}

}  // namespace

// part is the wrapper's (blocks,) f32 scratch; loss is a 0-d f32.
UBR_EXPORT int ubr_weighted_nll(const void* logits, const void* labels,
                                const void* weights, void* part, void* loss,
                                int N, int C, int blocks, float n,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || C > MAXC || blocks < 1) return (int)cudaErrorInvalidValue;
  nll_fwd_kernel<<<blocks, NTH, 0, s>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(weights), static_cast<float*>(part), N, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)sum_rows(static_cast<const float*>(part), blocks, 1, n,
                       static_cast<float*>(loss), s);
}

// g is the 0-d f32 cotangent of the loss, on the card (read there: no
// host round trip); grad is (N, C) f32.
UBR_EXPORT int ubr_weighted_nll_bwd(const void* logits, const void* labels,
                                    const void* weights, const void* g,
                                    void* grad, int N, int C, float n,
                                    void* stream) {
  if (C < 1 || C > MAXC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long blocks = ((long)N + NTH - 1) / NTH;
  nll_bwd_kernel<<<(unsigned)blocks, NTH, 0, s>>>(
      static_cast<const float*>(logits), static_cast<const int*>(labels),
      static_cast<const float*>(weights), static_cast<const float*>(g),
      static_cast<float*>(grad), N, C, n);
  return (int)cudaGetLastError();
}
