"""K2 — a whole stride-1 eval BasicBlock in one launch, optionally over
the implicit channel concat of two streams.

    out = relu( relu(conv2(m)·g2 + b2) + bypass(x) )
    m   = round_to_compute_dtype( relu(conv1(x)·g1 + b1) )
    x   = a, or concat([a, b], channels) — never materialised

conv1/conv2 are 3x3 'same'; the bypass is a 1x1 conv ``wb`` with
affine (gb, bb), or the identity when ``wb`` is None.

Replaces ubresnet_tpu/ops/pallas_conv.py:fused_basic_block
(_block_kernel) and fused_dual_block (_dual_block_kernel). Kernel:
ops/csrc/basic_block.cu — m for the output tile plus a one-pixel halo
is recomputed per tile and stays in shared memory; at the image border
m is zero (conv2's own padding), inside it the halo is real conv1
output.

Weights: w1 (3, 3, ca+cb, co), w2 (3, 3, co, co), wb (ca+cb, co) —
JAX kernel layouts; the first ``ca`` input channels read stream a.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.ops import _build

# (ca, cb, co, projection) compiled into the kernel library
SHAPES = _build.SHAPES["basic_block"]


def supports(ca: int, cb: int, co: int, proj: bool) -> bool:
    return (ca, cb, co, bool(proj)) in SHAPES


def _conv(x, w, pad):
    """f32 NCHW conv with a (kh, kw, ci, co) kernel."""
    return F.conv2d(x, w.float().permute(3, 2, 0, 1), padding=pad)


def basic_block_plain(a, b, w1, g1, b1, w2, g2, b2, wb=None, gb=None,
                      bb=None):
    """Plain PyTorch version: f32 math, m rounded to ``a.dtype`` before
    conv2 (as the kernel and the unfused path do), output ``a.dtype``."""
    x = a.float().permute(0, 3, 1, 2)
    if b is not None:
        x = torch.cat([x, b.float().permute(0, 3, 1, 2)], 1)

    def aff(y, g, beta):
        return y * g.float().view(1, -1, 1, 1) + beta.float().view(1, -1, 1, 1)

    m = torch.relu(aff(_conv(x, w1, 1), g1, b1)).to(a.dtype).float()
    y = torch.relu(aff(_conv(m, w2, 1), g2, b2))
    if wb is not None:
        r = aff(_conv(x, wb.view(1, 1, *wb.shape), 0), gb, bb)
    else:
        r = x
    out = torch.relu(y + r)
    return out.permute(0, 2, 3, 1).to(a.dtype).contiguous()


def basic_block(a: torch.Tensor, b: Optional[torch.Tensor],
                w1: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                wb: Optional[torch.Tensor] = None,
                gb: Optional[torch.Tensor] = None,
                bb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a (B, H, W, ca) NHWC, b None or (B, H, W, cb); weights as in the
    module docstring, affines (co,) f32. CPU tensors take the plain
    version; CUDA tensors (bf16 activations and weights) launch K2."""
    if a.device.type == "cpu":
        return basic_block_plain(a, b, w1, g1, b1, w2, g2, b2, wb, gb, bb)
    bsz, h, wd, ca = a.shape
    cb = 0 if b is None else b.shape[-1]
    co = w1.shape[-1]
    proj = wb is not None
    if not supports(ca, cb, co, proj):
        raise ValueError(f"basic_block kernel has no (ca, cb, co, proj) = "
                         f"{(ca, cb, co, proj)}; compiled: {sorted(SHAPES)}")
    dev = a.device
    bf, f32 = torch.bfloat16, torch.float32
    _build.check(a, "a", bf, (bsz, h, wd, ca), dev)
    if b is not None:
        _build.check(b, "b", bf, (bsz, h, wd, cb), dev)
    _build.check(w1, "w1", bf, (3, 3, ca + cb, co), dev)
    _build.check(w2, "w2", bf, (3, 3, co, co), dev)
    for name, t in (("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2)):
        _build.check(t, name, f32, (co,), dev)
    if proj:
        _build.check(wb, "wb", bf, (ca + cb, co), dev)
        _build.check(gb, "gb", f32, (co,), dev)
        _build.check(bb, "bb", f32, (co,), dev)
    out = torch.empty((bsz, h, wd, co), dtype=a.dtype, device=dev)
    _build.launch(
        "ubr_basic_block",
        [a, b, w1, g1, b1, w2, g2, b2, wb if proj else None,
         gb if proj else None, bb if proj else None, out],
        [bsz, h, wd, ca, cb, co], dev)
    basic_block.launches += 1
    return out


basic_block.launches = 0
