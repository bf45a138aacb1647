"""K3 — ConvTranspose2d(k=4, stride=2, padding=1, bias=False) at
exactly 2x.

Replaces ubresnet_tpu/ops/pallas_conv.py:fused_packed_deconv2x
(_deconv_kernel); in the UResNet it runs the dec2 and dec1 upsamples.
Kernel: ops/csrc/deconv2x.cu — each output pixel reads its 2x2 input
taps by row/column parity; a block owns one parity class, so only 4
of the 16 taps' weights sit in shared memory next to the input tile.

Weights are (4, 4, ci, co): the reference IOHW checkpoint permuted
(2, 3, 0, 1), with no spatial flip (torch semantics
``out[2i + k - 1] += w[k]·x[i]``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.ops import _build

# (ci, co) compiled into the kernel library
SHAPES = _build.SHAPES["deconv2x"]


def supports(ci: int, co: int) -> bool:
    return (ci, co) in SHAPES


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
    out = torch.empty((bsz, 2 * h, 2 * wd, co), dtype=x.dtype, device=dev)
    _build.launch("ubr_deconv2x", [x, w, out], [bsz, h, wd, ci, co], dev)
    deconv2x.launches += 1
    return out


deconv2x.launches = 0
