"""K3 — ConvTranspose2d(k=4, stride=2, padding=1, bias=False) at
exactly 2x.

Replaces ubresnet_tpu/ops/pallas_conv.py:fused_packed_deconv2x
(_deconv_kernel); in the UResNet it runs the dec2 and dec1 upsamples.
Kernel: ops/csrc/deconv2x.cu — each output pixel reads its 2x2 input
taps by row/column parity; a block owns one parity class, so only 4
of the 16 taps' weights sit in shared memory next to the input tile.

K3-s8 (``deconv2x_s8``) replaces the quantized=True mode of
fused_packed_deconv2x: s8 x s8 → s32, out = f32(acc)·g with g = sx·sw.
Kernel: ops/csrc/deconv2x_s8.cu — K3's parity blocks with __dp4a.

Weights are (4, 4, ci, co): the reference IOHW checkpoint permuted
(2, 3, 0, 1), with no spatial flip (torch semantics
``out[2i + k - 1] += w[k]·x[i]``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.ops import _build, quant

# (ci, co) compiled into the kernel library
SHAPES = _build.SHAPES["deconv2x"]
S8_SHAPES = _build.SHAPES["deconv2x_s8"]


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
    _build.check(wq, "wq", torch.int8, (4, 4, ci, co), dev)
    _build.check(g, "g", torch.float32, (co,), dev)
    out = torch.empty((bsz, 2 * h, 2 * wd, co), dtype=out_dtype, device=dev)
    _build.launch("ubr_deconv2x_s8", [xq, wq, g, out],
                  [bsz, h, wd, ci, co, flag], dev)
    deconv2x_s8.launches += 1
    return out


deconv2x_s8.launches = 0
