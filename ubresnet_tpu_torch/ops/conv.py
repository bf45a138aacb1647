"""K1 — stride-1 odd k x k 'same' conv with the fused eval epilogue
``y = conv(x)·g + b → [pre-ReLU] → [+ residual] → [ReLU]``.

Replaces ubresnet_tpu/ops/pallas_conv.py:fused_packed_conv
(_conv_kernel); in the UResNet it runs the 7x7 head conv10 (+bias+BN+
ReLU) and classifier conv11 (g = 1, b = bias, no ReLU). Kernel:
ops/csrc/conv_bn_act.cu — operations-bound on the H100 (392 op/B at
7x7 16→16); a 16x16 output tile per block with the haloed input and
all weights in shared memory and f32 FMA accumulation per pixel.

Weights are (k, k, ci, co) — the JAX kernel layout, i.e. the
reference OIHW checkpoint permuted (2, 3, 1, 0).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.ops import _build

# (ci, co, k) compiled into the kernel library
SHAPES = _build.SHAPES["conv_bn_act"]


def supports(ci: int, co: int, k: int) -> bool:
    return (ci, co, k) in SHAPES


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
