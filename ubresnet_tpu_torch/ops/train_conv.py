"""K5 — the train zone's convolution with its BatchNorm statistics,
and ``train_conv_stats``, the differentiable form the train-mode
blocks call.

    y, s1, s2 = conv_stats(x, w, bias)    # y = conv(x) + bias (bf16)
                                          # s1 = Σ y, s2 = Σ y² per channel

Replaces ubresnet_tpu/ops/pallas_train.py:train_conv_stats
(_conv_stats_kernel, _tcs_bwd). Kernel: ops/csrc/conv_stats.cu — K1's
bf16 tensor-core implicit GEMM (conv_gemm.cuh: mma.sync, a persistent
grid over 16x16 output tiles, weights laid out once per block, haloed
input tiles double-buffered by cp.async) with its own epilogue: bias,
bf16 y, and the sums of the emitted bf16 y kept per lane, reduced over
the block in a fixed order into the block's row of a scratch tensor and
added across the rows in order (two passes, no atomics), so they are
the same bits on every run.

The backward is _tcs_bwd's: the statistic cotangents fold into the
conv cotangent, dc = dy + ds1 + 2·y·ds2 (f32, an elementwise torch
pass, as it is XLA in JAX), cast to x's dtype; dx runs on K1 with the
flipped, transposed kernel (ops/conv.py:conv_input_grad), dW on K6
(ops/conv.py:conv_dw), dbias is Σ dc.

Weights are (k, k, ci, co), the reference OIHW permuted (2, 3, 1, 0).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.ops import _build
from ubresnet_tpu_torch.ops import conv as conv_ops

# (ci, co, k) compiled into the kernel library
SHAPES = _build.SHAPES["conv_stats"]
# rows of K5's partial-sum scratch per SM: the most blocks of any K5
# shape that one SM holds at once (conv_stats.cu: 3). The kernel runs
# min(rows, resident blocks) blocks, each over a strided share of the
# 16x16 output tiles, and adds that many rows.
BLOCKS_PER_SM = 3


def supports(ci: int, co: int, k: int) -> bool:
    """Every leg of train_conv_stats has a kernel for this shape: K5
    forward, K1 input gradient, K6 weight gradient."""
    return ((ci, co, k) in SHAPES and conv_ops.dw_supports(ci, co, k)
            and conv_ops.supports(co, ci, k))


def conv_stats_plain(x, w, bias=None):
    """Plain PyTorch version: f32 conv (+ bias), y in ``x.dtype``, sums
    of the emitted y in f32."""
    k = w.shape[0]
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 w.float().permute(3, 2, 0, 1), padding=k // 2)
    if bias is not None:
        y = y + bias.float().view(1, -1, 1, 1)
    y = y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    yf = y.float()
    return y, yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))


def conv_stats(x: torch.Tensor, w: torch.Tensor,
               bias: Optional[torch.Tensor] = None):
    """x (B, H, W, ci) NHWC; w (k, k, ci, co); bias None or (co,) f32.
    Returns y (B, H, W, co) in x's dtype and s1, s2 (co,) f32. CPU
    tensors take the plain version; CUDA tensors launch K5 (bf16 x/w)."""
    if x.device.type == "cpu":
        return conv_stats_plain(x, w, bias)
    bsz, h, wd, ci = x.shape
    k, _, _, co = w.shape
    if (ci, co, k) not in SHAPES:
        raise ValueError(f"conv_stats kernel has no (ci, co, k) = "
                         f"{(ci, co, k)}; compiled: {sorted(SHAPES)}")
    dev = x.device
    _build.check(x, "x", torch.bfloat16, (bsz, h, wd, ci), dev)
    _build.check(w, "w", torch.bfloat16, (k, k, ci, co), dev)
    if bias is not None:
        _build.check(bias, "bias", torch.float32, (co,), dev)
    tiles = bsz * -(-h // 16) * -(-wd // 16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = min(tiles, sms * BLOCKS_PER_SM)
    y = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=dev)
    part = torch.empty((blocks, 2 * co), dtype=torch.float32, device=dev)
    sums = torch.empty((2 * co,), dtype=torch.float32, device=dev)
    _build.launch("ubr_conv_stats", [x, w, bias, y, part, sums],
                  [bsz, h, wd, ci, co, k, blocks], dev)
    conv_stats.launches += 1
    return y, sums[:co], sums[co:]


conv_stats.launches = 0


class _TrainConvStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        x, w = x.contiguous(), w.contiguous()
        y, s1, s2 = conv_stats(x, w, bias)
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, y = ctx.saved_tensors
        dc = dy.float() + ds1 + 2.0 * y.float() * ds2
        dc = dc.to(x.dtype).contiguous()
        dx = conv_ops.conv_input_grad(dc, w)
        dw = conv_ops.conv_dw(x, dc, w.shape[0]).to(w.dtype)
        dbias = dc.float().sum((0, 1, 2)) if ctx.has_bias else None
        return dx, dw, dbias


def train_conv_stats(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None):
    """Differentiable ``conv_stats``: gradients flow from y, s1 and s2
    to x, w and bias (bias f32, its gradient f32)."""
    return _TrainConvStats.apply(x, w, bias)
