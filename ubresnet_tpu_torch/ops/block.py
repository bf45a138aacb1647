"""K2 — a whole stride-1 eval BasicBlock in one launch, optionally over
the implicit channel concat of two streams.

    out = relu( relu(conv2(m)·g2 + b2) + bypass(x) )
    m   = round_to_compute_dtype( relu(conv1(x)·g1 + b1) )
    x   = a, or concat([a, b], channels) — never materialised

conv1/conv2 are 3x3 'same'; the bypass is a 1x1 conv ``wb`` with
affine (gb, bb), or the identity when ``wb`` is None.

Replaces ubresnet_tpu/ops/pallas_conv.py:fused_basic_block
(_block_kernel) and fused_dual_block (_dual_block_kernel). Kernel:
ops/csrc/basic_block.cu — bf16 tensor-core implicit GEMMs (mma.sync)
over 16x16 output tiles in a persistent grid whose blocks hold the
weights in shared memory and stream x tiles in with double-buffered
cp.async; m for the output tile plus a one-pixel halo is recomputed per
tile and stays in shared memory; at the image border m is zero (conv2's
own padding), inside it the halo is real conv1 output. Where the
weights, two x tiles and m do not fit one block's shared memory (the
inplanes-32 UResNet's 64-channel blocks), the kernel streams the weights
a tap at a time through a cp.async ring instead (its streamed form,
chosen per shape at compile time); the wrapper passes scratch for the
fragments either way.

Weights: w1 (3, 3, ca+cb, co), w2 (3, 3, co, co), wb (ca+cb, co) —
JAX kernel layouts; the first ``ca`` input channels read stream a.

K2-s8 (``basic_block_s8``) replaces the quantized=True modes of
fused_basic_block and fused_dual_block: int8 streams sharing one scale,
s8 x s8 → s32, m requantized on chip to int8 as
rint(min(relu(acc1·g1 + b1), 127)) with conv2's scale folded into
g1/b1, the identity bypass dequantized as gb·x + bb. Kernel:
ops/csrc/basic_block_s8.cu — K2's design on the int8 tensor cores
(mma.sync m16n8k32, exact s32 accumulators; at 16 channels a 32-deep
k-step covers two taps), the f32 epilogue step for step the plain
version's, so the float32 output is bit-identical to it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.ops import _build, quant

# (ca, cb, co, projection) compiled into the kernel library
SHAPES = _build.SHAPES["basic_block"]
S8_SHAPES = _build.SHAPES["basic_block_s8"]


def supports(ca: int, cb: int, co: int, proj: bool) -> bool:
    return (ca, cb, co, bool(proj)) in SHAPES


def s8_supports(ca: int, cb: int, co: int, proj: bool) -> bool:
    return (ca, cb, co, bool(proj)) in S8_SHAPES


def _fragments(w1, w2, wb):
    """Scratch for the streamed form's weight fragments: the weights'
    own bytes (the resident form leaves it unread)."""
    n = w1.numel() + w2.numel() + (0 if wb is None else wb.numel())
    return torch.empty(n * w1.element_size(), dtype=torch.uint8,
                       device=w1.device)


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
    _build.check_aligned(a, "a")
    if b is not None:
        _build.check_aligned(b, "b")
    out = torch.empty((bsz, h, wd, co), dtype=a.dtype, device=dev)
    _build.launch(
        "ubr_basic_block",
        [a, b, w1, g1, b1, w2, g2, b2, wb if proj else None,
         gb if proj else None, bb if proj else None,
         _fragments(w1, w2, wb if proj else None), out],
        [bsz, h, wd, ca, cb, co], dev)
    basic_block.launches += 1
    return out


basic_block.launches = 0


def basic_block_s8_plain(aq, bq, w1q, g1, b1, w2q, g2, b2, wbq, gb, bb,
                         out_dtype=torch.bfloat16, with_mid=False):
    """Plain PyTorch version of K2-s8: exact integer convs
    (ops/quant.py:int_conv2d), float32 epilogues in the kernel's order
    (each affine one FMA, ops/quant.py:fma), output ``out_dtype``;
    ``with_mid`` also returns the requantized int8 intermediate m."""
    xq = aq if bq is None else torch.cat([aq, bq], -1)
    aff = quant.fma
    y1 = torch.relu(aff(quant.int_conv2d(xq, w1q, 1), g1, b1))
    m = torch.round(torch.clamp(y1, max=quant.INT8_MAX)).to(torch.int8)
    y = torch.relu(aff(quant.int_conv2d(m, w2q, 1), g2, b2))
    if wbq is not None:
        r = aff(quant.int_conv2d(xq, wbq.view(1, 1, *wbq.shape), 0), gb, bb)
    else:
        r = aff(xq.float(), gb, bb)
    out = torch.relu(y + r).to(out_dtype).contiguous()
    return (out, m) if with_mid else out


def basic_block_s8(aq: torch.Tensor, bq: Optional[torch.Tensor],
                   w1q: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                   w2q: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                   wbq: Optional[torch.Tensor], gb: torch.Tensor,
                   bb: torch.Tensor, *,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 K2: aq (B, H, W, ca) and bq None or (B, H, W, cb) int8
    (one shared scale); int8 weights in the layouts of the module
    docstring; g1/b1 carry sx·sw1/s_mid, g2 s_mid·sw2, gb/bb the bypass
    dequant (gb = sx, bb = 0 with the identity, wbq None). CPU tensors
    take the plain version; CUDA tensors launch K2-s8."""
    if aq.device.type == "cpu":
        return basic_block_s8_plain(aq, bq, w1q, g1, b1, w2q, g2, b2, wbq,
                                    gb, bb, out_dtype)
    bsz, h, wd, ca = aq.shape
    cb = 0 if bq is None else bq.shape[-1]
    co = w1q.shape[-1]
    proj = wbq is not None
    if not s8_supports(ca, cb, co, proj):
        raise ValueError(f"basic_block_s8 kernel has no (ca, cb, co, proj) "
                         f"= {(ca, cb, co, proj)}; compiled: "
                         f"{sorted(S8_SHAPES)}")
    dev = aq.device
    s8, f32 = torch.int8, torch.float32
    flag = _build.out_f32(out_dtype)
    _build.check(aq, "aq", s8, (bsz, h, wd, ca), dev)
    _build.check_aligned(aq, "aq")
    if bq is not None:
        _build.check(bq, "bq", s8, (bsz, h, wd, cb), dev)
        _build.check_aligned(bq, "bq")
    _build.check(w1q, "w1q", s8, (3, 3, ca + cb, co), dev)
    _build.check(w2q, "w2q", s8, (3, 3, co, co), dev)
    for name, t in (("g1", g1), ("b1", b1), ("g2", g2), ("b2", b2),
                    ("gb", gb), ("bb", bb)):
        _build.check(t, name, f32, (co,), dev)
    if proj:
        _build.check(wbq, "wbq", s8, (ca + cb, co), dev)
    out = torch.empty((bsz, h, wd, co), dtype=out_dtype, device=dev)
    _build.launch("ubr_basic_block_s8",
                  [aq, bq, w1q, g1, b1, w2q, g2, b2, wbq, gb, bb,
                   _fragments(w1q, w2q, wbq), out],
                  [bsz, h, wd, ca, cb, co, flag], dev)
    basic_block_s8.launches += 1
    return out


basic_block_s8.launches = 0
