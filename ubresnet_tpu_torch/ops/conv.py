"""K1 — stride-1 odd k x k 'same' conv with the fused eval epilogue
``y = conv(x)·g + b → [pre-ReLU] → [+ residual] → [ReLU]``, and K6 —
that conv's weight gradient; with them ``conv_ad``, the differentiable
stride-1 conv of the train zone's classifier.

K1 replaces ubresnet_tpu/ops/pallas_conv.py:fused_packed_conv
(_conv_kernel); in the UResNet it runs the 7x7 head conv10 (+bias+BN+
ReLU) and classifier conv11 (g = 1, b = bias, no ReLU) of the eval
forward, the classifier's train forward (g = 1, b = 0: _conv_noepi),
and every input gradient of the train zone (``conv_input_grad``: the
conv of dy with the flipped, in/out-transposed kernel, as
_conv_ad_bwd). Kernel: ops/csrc/conv_bn_act.cu — a bf16 tensor-core
implicit GEMM (mma.sync; M = a 16x16 output tile's pixels, N = co,
K = taps x ci) in a persistent grid, the weights laid out once per
block, the haloed input tiles double-buffered by cp.async.

K6 replaces ubresnet_tpu/ops/pallas_conv.py:pallas_conv_dw
(_dw_kernel). Kernel: ops/csrc/conv_dw.cu — per tile of 16-pixel rows
(flat pixel runs at 1x1, haloed image blocks at 3x3 and 7x7, through a
3- or 4-stage cp.async ring) a bf16 tensor-core GEMM with M = ci, N = co,
K = pixels, each x row's A fragment feeding the k tap rows of its tap
column (mma.sync; wgmma with B read by descriptor for the 3x3s at ci 64
and the 7x7s at co 16); a persistent grid of block pairs (clusters of
2), each block keeping its share of dW in registers, a pair's shares
added in rank order through distributed shared memory into one scratch
row, the rows by sum_rows in a fixed order (no atomics on dW).

``conv_ad`` replaces pallas_conv_ad (_conv_ad_fwd, _conv_ad_bwd):
forward K1, dx K1, dW K6 rounded to the kernel's dtype.

K1-s8 (``conv_bn_act_s8``) replaces the quantized=True mode of
fused_packed_conv (_conv_kernel): the head conv10 under int8 deploy,
s8 x s8 → s32 with the dequant scale folded into g. Kernel:
ops/csrc/conv_bn_act_s8.cu — K1's implicit GEMM (conv_gemm.cuh) on the
int8 tensor cores (mma.sync m16n8k32, exact s32 sums; at 16 channels two
taps a 32-deep k-step), in the same persistent grid.

Weights are (k, k, ci, co) — the JAX kernel layout, i.e. the
reference OIHW checkpoint permuted (2, 3, 1, 0).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.ops import _build, quant

# (ci, co, k) compiled into the kernel library
SHAPES = _build.SHAPES["conv_bn_act"]
DW_SHAPES = _build.SHAPES["conv_dw"]
S8_SHAPES = _build.SHAPES["conv_bn_act_s8"]


def supports(ci: int, co: int, k: int) -> bool:
    return (ci, co, k) in SHAPES


def dw_supports(ci: int, co: int, k: int) -> bool:
    return (ci, co, k) in DW_SHAPES


def _in_channels(c: int) -> int:
    """K1 reads its input channels in groups of 4."""
    return -(-c // 4) * 4


def ad_supports(ci: int, co: int, k: int) -> bool:
    """conv_ad has a kernel on every leg: K1 forward, K1 input gradient
    (co zero-padded to a multiple of 4), K6 weight gradient."""
    return (supports(ci, co, k) and supports(_in_channels(co), ci, k)
            and dw_supports(ci, co, k))


def conv_bn_act_plain(x, w, g, b, residual=None, *, pre_act=False,
                      act=True):
    """Plain PyTorch version: f32 math on the given values, output in
    ``x.dtype`` (NHWC, contiguous)."""
    k = w.shape[0]
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1), padding=k // 2)
    y = y * g.float().view(1, -1, 1, 1) + b.float().view(1, -1, 1, 1)
    if pre_act:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual.float().permute(0, 3, 1, 2)
    if act:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def conv_bn_act(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                b: torch.Tensor, residual: Optional[torch.Tensor] = None,
                *, pre_act: bool = False, act: bool = True) -> torch.Tensor:
    """x (B, H, W, ci) NHWC; w (k, k, ci, co); g, b (co,) f32 folded
    affine; residual optional (B, H, W, co). CPU tensors take the plain
    version; CUDA tensors launch K1 (bf16 x/w/residual, f32 g/b)."""
    if x.device.type == "cpu":
        return conv_bn_act_plain(x, w, g, b, residual, pre_act=pre_act,
                                 act=act)
    bsz, h, wd, ci = x.shape
    k, _, _, co = w.shape
    if not supports(ci, co, k):
        raise ValueError(f"conv_bn_act kernel has no (ci, co, k) = "
                         f"{(ci, co, k)}; compiled: {sorted(SHAPES)}")
    dev = x.device
    _build.check(x, "x", torch.bfloat16, (bsz, h, wd, ci), dev)
    _build.check(w, "w", torch.bfloat16, (k, k, ci, co), dev)
    _build.check(g, "g", torch.float32, (co,), dev)
    _build.check(b, "b", torch.float32, (co,), dev)
    if residual is not None:
        _build.check(residual, "residual", torch.bfloat16, (bsz, h, wd, co),
                     dev)
    out = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=dev)
    _build.launch("ubr_conv_bn_act", [x, w, g, b, residual, out],
                  [bsz, h, wd, ci, co, k, pre_act, act], dev)
    conv_bn_act.launches += 1
    return out


conv_bn_act.launches = 0


def s8_supports(ci: int, co: int, k: int) -> bool:
    return (ci, co, k) in S8_SHAPES


def conv_bn_act_s8_plain(xq, wq, g, b, residual=None, *, pre_act=False,
                         act=True, out_dtype=torch.bfloat16):
    """Plain PyTorch version of K1-s8: the exact integer conv
    (ops/quant.py:int_conv2d), then the epilogue in float32 in K1-s8's
    order (the affine one FMA, ops/quant.py:fma), output ``out_dtype``
    (NHWC, contiguous)."""
    y = quant.fma(quant.int_conv2d(xq, wq, wq.shape[0] // 2), g, b)
    if pre_act:
        y = torch.relu(y)
    if residual is not None:
        y = y + residual.float()
    if act:
        y = torch.relu(y)
    return y.to(out_dtype).contiguous()


def conv_bn_act_s8(xq: torch.Tensor, wq: torch.Tensor, g: torch.Tensor,
                   b: torch.Tensor, residual: Optional[torch.Tensor] = None,
                   *, pre_act: bool = False, act: bool = True,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 K1: xq (B, H, W, ci) int8 NHWC; wq (k, k, ci, co) int8;
    g, b (co,) f32 with the dequant scale folded into g; residual
    optional (B, H, W, co) in ``out_dtype``. CPU tensors take the plain
    version; CUDA tensors launch K1-s8 (bf16 or f32 output)."""
    if xq.device.type == "cpu":
        return conv_bn_act_s8_plain(xq, wq, g, b, residual, pre_act=pre_act,
                                    act=act, out_dtype=out_dtype)
    bsz, h, wd, ci = xq.shape
    k, _, _, co = wq.shape
    if not s8_supports(ci, co, k):
        raise ValueError(f"conv_bn_act_s8 kernel has no (ci, co, k) = "
                         f"{(ci, co, k)}; compiled: {sorted(S8_SHAPES)}")
    dev = xq.device
    f32 = _build.out_f32(out_dtype)
    _build.check(xq, "xq", torch.int8, (bsz, h, wd, ci), dev)
    _build.check_aligned(xq, "xq")
    _build.check(wq, "wq", torch.int8, (k, k, ci, co), dev)
    _build.check(g, "g", torch.float32, (co,), dev)
    _build.check(b, "b", torch.float32, (co,), dev)
    if residual is not None:
        _build.check(residual, "residual", out_dtype, (bsz, h, wd, co), dev)
    out = torch.empty((bsz, h, wd, co), dtype=out_dtype, device=dev)
    _build.launch("ubr_conv_bn_act_s8", [xq, wq, g, b, residual, out],
                  [bsz, h, wd, ci, co, k, pre_act, act, f32], dev)
    conv_bn_act_s8.launches += 1
    return out


conv_bn_act_s8.launches = 0


def conv_input_grad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of the stride-1 'same' conv with kernel ``w`` (k, k, ci, co)
    at output cotangent ``dy`` (B, H, W, co): the same conv of dy with
    the spatially flipped, in/out-transposed kernel, on K1 (g = 1,
    b = 0, no ReLU). A co that is no multiple of 4 (the 3-class
    classifier) is zero-padded, as _conv_ad_bwd pads to _pad_channels."""
    k, _, ci, co = w.shape
    wt = w.flip((0, 1)).transpose(2, 3)
    cp = _in_channels(co)
    if cp != co:
        dy = F.pad(dy, (0, cp - co))
        wt = F.pad(wt, (0, 0, 0, cp - co))
    ones = torch.ones(ci, device=dy.device)
    return conv_bn_act(dy.contiguous(), wt.contiguous(), ones,
                       torch.zeros_like(ones), act=False)


def conv_dw_plain(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of K6: f32 weight gradient, (k, k, ci, co)."""
    dw = torch.nn.grad.conv2d_weight(
        x.float().permute(0, 3, 1, 2), (dy.shape[-1], x.shape[-1], k, k),
        dy.float().permute(0, 3, 1, 2), padding=k // 2)
    return dw.permute(2, 3, 1, 0).contiguous()


def dw_grid(ci: int, co: int, k: int, bsz: int, h: int, wd: int,
            device: torch.device, rows: int = 1 << 30) -> dict:
    """K6's launch geometry for an (ci, co, k) instance and a (bsz, h,
    wd) batch on ``device``: the most clusters that fit at once
    (``most``), the ring's stages, the pixels of a tile, the batch's
    tiles, the clusters a launch with ``rows`` scratch rows takes
    (``clusters``: each writes one (k, k, ci, co) f32 row, which
    sum_rows reads back) and the blocks of a cluster."""
    if not dw_supports(ci, co, k):
        raise ValueError(f"conv_dw kernel has no (ci, co, k) = "
                         f"{(ci, co, k)}; compiled: {sorted(DW_SHAPES)}")
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        rc = _build.library().ubr_conv_dw_grid(
            ctypes.addressof(out), bsz, h, wd, ci, co, k, rows)
    if rc:
        raise RuntimeError(f"ubr_conv_dw_grid: CUDA error {rc}")
    return dict(zip(("most", "stages", "tile_pixels", "tiles", "clusters",
                     "cluster_blocks"), out))


@functools.lru_cache(maxsize=None)
def _dw_rows(dev: torch.device, ci: int, co: int, k: int) -> int:
    """K6's scratch rows on ``dev``: one per cluster of blocks that fits
    on the card at once (asked once per instance)."""
    return dw_grid(ci, co, k, 1, 1, 1, dev)["most"]


def conv_dw(x: torch.Tensor, dy: torch.Tensor, k: int) -> torch.Tensor:
    """Weight gradient of the stride-1 'same' k x k conv: x (B, H, W, ci)
    its input, dy (B, H, W, co) its output cotangent → (k, k, ci, co)
    f32. CPU tensors take the plain version; CUDA tensors (bf16) launch
    K6 with a (clusters, k*k*ci*co) f32 scratch, one row a cluster of
    blocks that fits on the card (``_dw_rows``)."""
    if x.device.type == "cpu":
        return conv_dw_plain(x, dy, k)
    bsz, h, wd, ci = x.shape
    co = dy.shape[-1]
    if not dw_supports(ci, co, k):
        raise ValueError(f"conv_dw kernel has no (ci, co, k) = "
                         f"{(ci, co, k)}; compiled: {sorted(DW_SHAPES)}")
    dev = x.device
    _build.check(x, "x", torch.bfloat16, (bsz, h, wd, ci), dev)
    _build.check(dy, "dy", torch.bfloat16, (bsz, h, wd, co), dev)
    _build.check_aligned(x, "x")
    _build.check_aligned(dy, "dy")
    rows = _dw_rows(dev, ci, co, k)
    part = torch.empty((rows, k * k * ci * co), dtype=torch.float32,
                       device=dev)
    dw = torch.empty((k, k, ci, co), dtype=torch.float32, device=dev)
    _build.launch("ubr_conv_dw", [x, dy, part, dw],
                  [bsz, h, wd, ci, co, k, rows], dev)
    conv_dw.launches += 1
    return dw


conv_dw.launches = 0


class _ConvAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        co = w.shape[-1]
        ones = torch.ones(co, device=x.device)
        ctx.save_for_backward(x, w)
        return conv_bn_act(x, w, ones, torch.zeros_like(ones), act=False)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = conv_input_grad(dy, w)
        dw = conv_dw(x, dy, w.shape[0]).to(w.dtype)
        return dx, dw


def conv_ad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable stride-1 'same' conv, no bias: x (B, H, W, ci),
    w (k, k, ci, co) → (B, H, W, co) in x's dtype."""
    return _ConvAD.apply(x, w)
