"""K4 — 3x3 stride-2 pad-1 max pool (the UResNet stem pool), and its
differentiable form ``maxpool3x3s2_ad`` (forward K4, dense first-match
backward in plain torch) for training.

Replaces ubresnet_tpu/ops/pallas_conv.py:fused_pool3x3s2 and, with
the backward, ops/pool_ad.py:packed_pool_ad. Kernel:
ops/csrc/maxpool3x3s2.cu — bytes-bound on the H100 (one read of the
input, a quarter-size write); one thread per (output pixel, 8
channels) with 16-byte loads and bf16x2 max, bit-exact. It pads with
-inf, which equals the TPU kernel's zero padding on its non-negative
(post-ReLU) domain.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.ops import _build


def maxpool3x3s2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: NHWC in, NHWC (contiguous) out."""
    y = F.max_pool2d(x.float().permute(0, 3, 1, 2), 3, 2, 1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def maxpool3x3s2(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(3, 2, 1) over NHWC ``x``. CPU tensors take the plain
    version; CUDA tensors (bf16, contiguous, C % 8 == 0) launch K4."""
    if x.device.type == "cpu":
        return maxpool3x3s2_plain(x)
    b, h, w, c = x.shape
    _build.check(x, "x", torch.bfloat16, (b, h, w, c), x.device)
    if c % 8:
        raise ValueError(f"maxpool3x3s2 kernel needs C % 8 == 0, got {c}")
    out = torch.empty((b, (h + 1) // 2, (w + 1) // 2, c), dtype=x.dtype,
                      device=x.device)
    _build.launch("ubr_maxpool3x3s2", [x, out], [b, h, w, c], x.device)
    maxpool3x3s2.launches += 1
    return out


maxpool3x3s2.launches = 0


def pool_backward(x: torch.Tensor, y: torch.Tensor,
                  dy: torch.Tensor) -> torch.Tensor:
    """dx of MaxPool2d(3, 2, 1) over NHWC ``x`` with output ``y`` and
    output cotangent ``dy``: each window's cotangent goes to its first
    maximum in row-major window order (the tie rule of XLA's
    SelectAndScatter and of torch's argmax), padding is -inf. The dense
    form of ubresnet_tpu/ops/pool_ad.py:pool_backward — per-tap
    first-match masks, no scatter — with its sums in the same order:
    per column tap, row taps (0 + 2) then 1; then column taps 0 + 2,
    then 1."""
    b, h, w, c = x.shape
    ho, wo = y.shape[1], y.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=float("-inf"))
    found = torch.zeros(y.shape, dtype=torch.bool, device=x.device)
    contrib = {}
    for kr in range(3):
        for kc in range(3):
            xk = xp[:, kr:kr + 2 * ho - 1:2, kc:kc + 2 * wo - 1:2]
            eq = (xk == y) & ~found
            found |= eq
            contrib[kr, kc] = torch.where(eq, dy, torch.zeros_like(dy))
    dxp = dy.new_zeros((b, 2 * ho + 2, 2 * wo + 2, c))
    for kc in range(3):
        col = dy.new_zeros((b, 2 * ho + 2, wo, c))
        col[:, 0:2 * ho:2] += contrib[0, kc]
        col[:, 2:2 * ho + 2:2] += contrib[2, kc]
        col[:, 1:2 * ho:2] += contrib[1, kc]
        dxp[:, :, kc:kc + 2 * wo:2] += col
    return dxp[:, 1:h + 1, 1:w + 1].contiguous()


class _MaxPoolAD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = maxpool3x3s2(x.contiguous())
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return pool_backward(x, y, dy)


def maxpool3x3s2_ad(x: torch.Tensor) -> torch.Tensor:
    """Differentiable stem pool, the counterpart of
    ubresnet_tpu/ops/pool_ad.py:packed_pool_ad: forward K4 (non-negative
    input, as after the stem ReLU), backward ``pool_backward`` in plain
    torch, as JAX computes it in XLA."""
    return _MaxPoolAD.apply(x)
