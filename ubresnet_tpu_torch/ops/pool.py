"""K4 — 3x3 stride-2 pad-1 max pool (the UResNet stem pool).

Replaces ubresnet_tpu/ops/pallas_conv.py:fused_pool3x3s2. Kernel:
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


def supports(c: int, h: int, w: int) -> bool:
    """Shapes the kernel zone routes here: even spatial dims (as the
    JAX stem-pool gate) and channels in 16-byte groups."""
    return c % 8 == 0 and h % 2 == 0 and w % 2 == 0


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
