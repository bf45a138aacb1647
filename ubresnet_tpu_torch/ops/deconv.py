"""K3 — ConvTranspose2d(k=4, stride=2, padding=1, bias=False) at
exactly 2x; K8 and K9 — its input and weight gradients; K10 — both in
one launch; and ``deconv2x_ad``, the differentiable deconv of the train
configuration ``Policy.fused_train_deconv``.

Replaces ubresnet_tpu/ops/pallas_conv.py:fused_packed_deconv2x
(_deconv_kernel); in the UResNet it runs the dec2 and dec1 upsamples.
Kernel: ops/csrc/deconv2x.cu — each output pixel reads its 2x2 input
taps by row/column parity, so each parity class is a GEMM [pixels x
4·ci] x [4·ci x co] on bf16 tensor cores (mma.sync); a persistent block
holds all 16 taps' weights in shared memory and takes each 16x16 input
tile (double-buffered cp.async) with all four classes of its output.

K3-s8 (``deconv2x_s8``) replaces the quantized=True mode of
fused_packed_deconv2x: s8 x s8 → s32, out = f32(acc)·g with g = sx·sw.
Kernel: ops/csrc/deconv2x_s8.cu — K3's design on the int8 tensor cores
(mma.sync m16n8k32, exact s32 sums): the four parity GEMMs of each
16x16 input tile from one read of it, in a persistent grid.

K8 (``conv_s2k4``) replaces fused_conv_s2k4 (_s2k4_kernel): the
stride-2 k4 pad-1 cross-correlation ``dx[i] = Σ_k w[k]·dy[2i + k - 1]``
(per spatial axis, contracting co) of the deconv's output cotangent
with its own kernel. Kernel: ops/csrc/conv_s2k4.cu — a bf16 tensor-core
implicit GEMM (mma.sync; M = a dx tile's pixels, N = ci, K = 16 taps x
co tap-major) in a persistent grid; each haloed dy tile arrives by
double-buffered cp.async as its four (row, column) parity planes, so
every tap reads one plane at stride 1; the weights are laid out once per
block.

K9 (``deconv_dw``) replaces pallas_deconv_dw (_deconv_dw_kernel):
``dW[k] = Σ x[i]·dy[2i + k - 1]``. Kernel: ops/csrc/deconv_dw.cu — per
x tile and tap a bf16 tensor-core GEMM x_tileᵀ·dy_tap (mma.sync; M = ci,
N = co, K = the tile's pixels), both operands by ldmatrix.trans, dy
arriving as K8's four parity planes; a persistent grid whose blocks keep
their share of dW in registers, added across blocks in a fixed order
(two passes, no atomics), as K6.

K10 (``deconv2x_bwd``) replaces _deconv_ad_bwd, the backward of
pallas_deconv2x_ad (its fused_conv_s2k4 and pallas_deconv_dw calls):
dx and dW from one read of x, dy and w. Kernel: ops/csrc/deconv2x_bwd.cu
— K8's and K9's GEMMs on one tile walk (ops/csrc/parity_tiles.cuh,
which K8 and K9 also run), the blocks' shares of dW added in a fixed
order in the same launch by clusters of 8 blocks through distributed
shared memory, then the clusters' rows by the cluster that finishes
last.

``deconv2x_ad`` replaces pallas_deconv2x_ad (_deconv_ad_fwd,
_deconv_ad_bwd): forward K3, backward K10, dx cast to x's dtype, dW
rounded to the kernel's dtype.

Weights are (4, 4, ci, co): the reference IOHW checkpoint permuted
(2, 3, 0, 1), with no spatial flip (torch semantics
``out[2i + k - 1] += w[k]·x[i]``).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.ops import _build, quant

# (ci, co) compiled into the kernel library
SHAPES = _build.SHAPES["deconv2x"]
S8_SHAPES = _build.SHAPES["deconv2x_s8"]
S2K4_SHAPES = _build.SHAPES["conv_s2k4"]
DW_SHAPES = _build.SHAPES["deconv_dw"]
BWD_SHAPES = _build.SHAPES["deconv2x_bwd"]
# K9's scratch rows per SM: at most this many of its blocks fit on an
# SM (shared memory: 111 KB a block at dec2, 107 KB at dec1). The kernel
# runs min(rows, SMs x the blocks that fit) blocks, each walking a
# strided share of the x tiles, and adds exactly the rows they wrote.
DW_BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def supports(ci: int, co: int) -> bool:
    return (ci, co) in SHAPES


def s8_supports(ci: int, co: int) -> bool:
    return (ci, co) in S8_SHAPES


def deconv2x_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: f32 math, output in ``x.dtype`` (NHWC)."""
    y = F.conv_transpose2d(x.float().permute(0, 3, 1, 2),
                           w.float().permute(2, 3, 0, 1), stride=2,
                           padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def deconv2x(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, ci) NHWC, w (4, 4, ci, co) → (B, 2H, 2W, co). CPU
    tensors take the plain version; CUDA tensors (bf16) launch K3."""
    if x.device.type == "cpu":
        return deconv2x_plain(x, w)
    bsz, h, wd, ci = x.shape
    co = w.shape[-1]
    if not supports(ci, co):
        raise ValueError(f"deconv2x kernel has no (ci, co) = {(ci, co)}; "
                         f"compiled: {sorted(SHAPES)}")
    dev = x.device
    _build.check(x, "x", torch.bfloat16, (bsz, h, wd, ci), dev)
    _build.check(w, "w", torch.bfloat16, (4, 4, ci, co), dev)
    _build.check_aligned(x, "x")
    out = torch.empty((bsz, 2 * h, 2 * wd, co), dtype=x.dtype, device=dev)
    _build.launch("ubr_deconv2x", [x, w, out], [bsz, h, wd, ci, co], dev)
    deconv2x.launches += 1
    return out


deconv2x.launches = 0


def deconv2x_s8_plain(xq: torch.Tensor, wq: torch.Tensor, g: torch.Tensor,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of K3-s8: the exact integer deconv
    (ops/quant.py:int_conv_transpose2d) times g, output ``out_dtype``."""
    acc = quant.int_conv_transpose2d(xq, wq)
    return (acc * g.float()).to(out_dtype).contiguous()


def deconv2x_s8(xq: torch.Tensor, wq: torch.Tensor, g: torch.Tensor, *,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 K3: xq (B, H, W, ci) int8, wq (4, 4, ci, co) int8, g (co,)
    f32 dequant (sx·sw) → (B, 2H, 2W, co) ``out_dtype``. CPU tensors
    take the plain version; CUDA tensors launch K3-s8."""
    if xq.device.type == "cpu":
        return deconv2x_s8_plain(xq, wq, g, out_dtype)
    bsz, h, wd, ci = xq.shape
    co = wq.shape[-1]
    if not s8_supports(ci, co):
        raise ValueError(f"deconv2x_s8 kernel has no (ci, co) = {(ci, co)}; "
                         f"compiled: {sorted(S8_SHAPES)}")
    dev = xq.device
    flag = _build.out_f32(out_dtype)
    _build.check(xq, "xq", torch.int8, (bsz, h, wd, ci), dev)
    _build.check_aligned(xq, "xq")
    _build.check(wq, "wq", torch.int8, (4, 4, ci, co), dev)
    _build.check(g, "g", torch.float32, (co,), dev)
    out = torch.empty((bsz, 2 * h, 2 * wd, co), dtype=out_dtype, device=dev)
    _build.launch("ubr_deconv2x_s8", [xq, wq, g, out],
                  [bsz, h, wd, ci, co, flag], dev)
    deconv2x_s8.launches += 1
    return out


deconv2x_s8.launches = 0


def conv_s2k4_plain(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8: one f32 ``F.conv2d`` of dy with w
    viewed as OIHW (O = ci, I = co), stride 2, padding 1; output in
    ``dy.dtype`` (NHWC)."""
    y = F.conv2d(dy.float().permute(0, 3, 1, 2),
                 w.float().permute(2, 3, 0, 1), stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(dy.dtype).contiguous()


def conv_s2k4(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the 2x deconv with kernel ``w`` (4, 4, ci, co)
    at output cotangent ``dy`` (B, 2H, 2W, co) → (B, H, W, ci). CPU
    tensors take the plain version; CUDA tensors (bf16) launch K8."""
    if dy.device.type == "cpu":
        return conv_s2k4_plain(dy, w)
    bsz, h2, w2, co = dy.shape
    ci = w.shape[2]
    if h2 % 2 or w2 % 2:
        raise ValueError(f"conv_s2k4: dy spatial {(h2, w2)} is not even")
    if (ci, co) not in S2K4_SHAPES:
        raise ValueError(f"conv_s2k4 kernel has no (ci, co) = {(ci, co)}; "
                         f"compiled: {sorted(S2K4_SHAPES)}")
    dev = dy.device
    h, wd = h2 // 2, w2 // 2
    _build.check(dy, "dy", torch.bfloat16, (bsz, h2, w2, co), dev)
    _build.check(w, "w", torch.bfloat16, (4, 4, ci, co), dev)
    _build.check_aligned(dy, "dy")
    out = torch.empty((bsz, h, wd, ci), dtype=dy.dtype, device=dev)
    _build.launch("ubr_conv_s2k4", [dy, w, out], [bsz, h, wd, ci, co], dev)
    conv_s2k4.launches += 1
    return out


conv_s2k4.launches = 0


def deconv_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9: f32 weight gradient, (4, 4, ci, co)
    — the gradient of the stride-2 conv dy → x with respect to its
    (ci, co, 4, 4) kernel."""
    dw = torch.nn.grad.conv2d_weight(
        dy.float().permute(0, 3, 1, 2), (x.shape[-1], dy.shape[-1], 4, 4),
        x.float().permute(0, 3, 1, 2), stride=2, padding=1)
    return dw.permute(2, 3, 0, 1).contiguous()


def deconv_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient of the 2x deconv: x (B, H, W, ci) its input, dy
    (B, 2H, 2W, co) its output cotangent → (4, 4, ci, co) f32. CPU
    tensors take the plain version; CUDA tensors (bf16) launch K9."""
    if x.device.type == "cpu":
        return deconv_dw_plain(x, dy)
    bsz, h, wd, ci = x.shape
    co = dy.shape[-1]
    if (ci, co) not in DW_SHAPES:
        raise ValueError(f"deconv_dw kernel has no (ci, co) = {(ci, co)}; "
                         f"compiled: {sorted(DW_SHAPES)}")
    dev = x.device
    _build.check(x, "x", torch.bfloat16, (bsz, h, wd, ci), dev)
    _build.check(dy, "dy", torch.bfloat16, (bsz, 2 * h, 2 * wd, co), dev)
    _build.check_aligned(x, "x")
    _build.check_aligned(dy, "dy")
    th = 8 if ci >= 64 else 16  # K9's x tiles: 8x16 at dec2, 16x16 below
    tiles = bsz * -(-h // th) * -(-wd // 16)
    blocks = min(tiles, _sm_count(dev) * DW_BLOCKS_PER_SM)
    part = torch.empty((blocks, 16 * ci * co), dtype=torch.float32,
                       device=dev)
    dw = torch.empty((4, 4, ci, co), dtype=torch.float32, device=dev)
    _build.launch("ubr_deconv_dw", [x, dy, part, dw],
                  [bsz, h, wd, ci, co, blocks], dev)
    deconv_dw.launches += 1
    return dw


deconv_dw.launches = 0


def deconv2x_bwd_plain(x: torch.Tensor, dy: torch.Tensor,
                       w: torch.Tensor):
    """Plain PyTorch version of K10: (dx, dW) in f32 math, dx in
    ``dy.dtype`` (K8's plain version), dW f32 (K9's)."""
    return conv_s2k4_plain(dy, w), deconv_dw_plain(x, dy)


# K10's scratch rows: one a cluster of 8 blocks, at most 2 blocks an SM
# (shared memory: 189 KB a block at dec2, 136 KB at dec1, 104 KB and 96
# KB at the 8-channel instances). The kernel runs min(rows, the clusters
# that fit) clusters and adds exactly the rows they wrote.
BWD_CLUSTER, BWD_BLOCKS_PER_SM = 8, 2


@functools.lru_cache(maxsize=None)
def _bwd_scratch(dev: torch.device, ci: int, co: int):
    """K10's scratch rows and its counter on ``dev``, made once: the
    counter starts at 0 and every launch leaves it at 0, so launches on
    one stream share them."""
    rows = -(-_sm_count(dev) * BWD_BLOCKS_PER_SM // BWD_CLUSTER)
    return (torch.empty((rows, 16 * ci * co), dtype=torch.float32,
                        device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))


def deconv2x_bwd(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor):
    """Backward of the 2x deconv with input x (B, H, W, ci), kernel w
    (4, 4, ci, co) and output cotangent dy (B, 2H, 2W, co) → (dx
    (B, H, W, ci) in dy's dtype, dW (4, 4, ci, co) f32). CPU tensors take
    the plain version; CUDA tensors (bf16) launch K10."""
    if x.device.type == "cpu":
        return deconv2x_bwd_plain(x, dy, w)
    bsz, h, wd, ci = x.shape
    co = w.shape[-1]
    if (ci, co) not in BWD_SHAPES:
        raise ValueError(f"deconv2x_bwd kernel has no (ci, co) = "
                         f"{(ci, co)}; compiled: {sorted(BWD_SHAPES)}")
    dev = x.device
    _build.check(x, "x", torch.bfloat16, (bsz, h, wd, ci), dev)
    _build.check(dy, "dy", torch.bfloat16, (bsz, 2 * h, 2 * wd, co), dev)
    _build.check(w, "w", torch.bfloat16, (4, 4, ci, co), dev)
    _build.check_aligned(x, "x")
    _build.check_aligned(dy, "dy")
    part, done = _bwd_scratch(dev, ci, co)
    dx = torch.empty((bsz, h, wd, ci), dtype=dy.dtype, device=dev)
    dw = torch.empty((4, 4, ci, co), dtype=torch.float32, device=dev)
    _build.launch("ubr_deconv2x_bwd", [x, dy, w, dx, part, done, dw],
                  [bsz, h, wd, ci, co, part.shape[0]], dev)
    deconv2x_bwd.launches += 1
    return dx, dw


deconv2x_bwd.launches = 0


class _Deconv2xAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        if not x.is_contiguous():
            x = x.contiguous()
        if not w.is_contiguous():
            w = w.contiguous()
        ctx.save_for_backward(x, w)
        return deconv2x(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        if dy.dtype != x.dtype or not dy.is_contiguous():
            dy = dy.to(x.dtype).contiguous()
        dx, dw = deconv2x_bwd(x, dy, w if w.dtype == dy.dtype
                              else w.to(dy.dtype))
        return dx.to(x.dtype), dw.to(w.dtype)


def deconv2x_ad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable exact-2x ConvTranspose2d(k=4, s=2, p=1): x
    (B, H, W, ci), w (4, 4, ci, co) → (B, 2H, 2W, co) in x's dtype;
    dW is rounded to w's dtype, as the JAX package's custom VJP."""
    return _Deconv2xAD.apply(x, w)
