"""Eval-mode building blocks of the U-ResNet family, NHWC
(counterpart of ubresnet_tpu/models/blocks.py).

Every module is built from a reference-format state_dict (the
``parity/torch_oracle.py`` key names) and prepares its weights once, at
construction, on its device (cuda unless ``device="cpu"`` is passed;
no card and no explicit cpu raises, utils/platform.py):

  * a layer that runs as a torch.nn.functional op (cuDNN on the card)
    keeps its conv weight with the eval BatchNorm (and conv bias)
    folded in, cast to the compute dtype, in channels-last form;
  * a layer that a Hopper kernel runs (ops/) keeps its kernel in the
    JAX layout (HWIO), cast to the compute dtype, and the folded BN as
    an f32 affine (g, b) for the kernel's epilogue.

Which of the two a layer is follows from its shape, as in the JAX
package: the kernel zone is every stride-1 layer whose channel shape
the kernel library was compiled for (ops/_build.py:SHAPES) — at the
flagship width exactly the stem pool, enc1, dec2, dec1, the head and
the classifier — plus the per-call spatial gates (exact 2x deconv,
even pool input). Nothing routes by catching a failure.

Reference semantics kept (common_layers.py via the JAX package):
BasicBlock applies ReLU to the residual branch before the add and again
after it; BN eps is 1e-5; the decoder concat order is [up, skip].
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.ops import block as block_ops
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import deconv as deconv_ops
from ubresnet_tpu_torch.ops import pool as pool_ops
from ubresnet_tpu_torch.utils.platform import resolve_device

BN_EPS = 1e-5

StateDict = Dict[str, torch.Tensor]


def fold_bn(scale, bias, mean, var, cbias=None, eps: float = BN_EPS):
    """Eval BN (+ optional conv bias) → one f32 affine y = conv·g + b."""
    g = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * g
    if cbias is not None:
        b = b + g * cbias.float()
    return g, b


def _affine(sd: StateDict, conv_key: str, bn_key: Optional[str]):
    """Folded (g, b) of conv ``conv_key`` followed by BN ``bn_key``
    (None: no BN — g = 1, b = conv bias or 0)."""
    w = sd[f"{conv_key}.weight"]
    cbias = sd.get(f"{conv_key}.bias")
    if bn_key is None:
        co = w.shape[0]
        g = torch.ones(co)
        b = cbias.float() if cbias is not None else torch.zeros(co)
        return g, b
    return fold_bn(sd[f"{bn_key}.weight"], sd[f"{bn_key}.bias"],
                   sd[f"{bn_key}.running_mean"], sd[f"{bn_key}.running_var"],
                   cbias)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """Zero-copy channels-last NCHW view of a contiguous NHWC tensor."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


class ConvBN(nn.Module):
    """Stride-1 'same' conv (+bias) → eval BN → [ReLU]; ``bn_key=None``
    drops the BN (the classifier). Runs on K1 (ops/conv.py) when the
    policy fuses and (ci, co, k) is compiled, else as one F.conv2d with
    BN folded into its weight and bias."""

    def __init__(self, sd: StateDict, conv_key: str, bn_key: Optional[str],
                 *, act: bool = True, policy: Policy = Policy(), device=None):
        super().__init__()
        device = resolve_device(device)
        w = sd[f"{conv_key}.weight"].float()  # OIHW
        co, ci, k, _ = w.shape
        g, b = _affine(sd, conv_key, bn_key)
        cdt = policy.compute_dtype
        self.pad, self.act = k // 2, act
        self.kernel = policy.fused_eval and conv_ops.supports(ci, co, k)
        if self.kernel:
            self.register_buffer(
                "w", w.permute(2, 3, 1, 0).to(device, cdt).contiguous())
            self.register_buffer("g", g.to(device))
            self.register_buffer("b", b.to(device))
        else:
            self.register_buffer("w", (w * g.view(-1, 1, 1, 1)).to(
                device, cdt).contiguous(memory_format=torch.channels_last))
            self.register_buffer("b", b.to(device, cdt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel:
            return conv_ops.conv_bn_act(x, self.w, self.g, self.b,
                                        act=self.act)
        y = F.conv2d(_nchw(x), self.w, self.b, padding=self.pad)
        if self.act:
            y = torch.relu(y)
        return _nhwc(y)


class BasicBlock(nn.Module):
    """Two 3x3 conv-BN-ReLU + bypass (1x1 conv-BN projection when the
    channels or the stride change), pre-add ReLU, add, ReLU.

    ``dual_split``: the block's input is the channel concat of two
    streams and the first ``dual_split`` channels come from the first
    (the decoder's [up, skip] join); ``forward(x, dual=skip)``. On K2
    the concat never materialises; the F.conv2d path concatenates."""

    def __init__(self, sd: StateDict, pref: str, *, stride: int = 1,
                 dual_split: int = 0, policy: Policy = Policy(),
                 device=None):
        super().__init__()
        device = resolve_device(device)
        w1 = sd[f"{pref}.conv1.weight"].float()
        co, cin = w1.shape[:2]
        self.proj = f"{pref}.bypass.weight" in sd
        self.stride = stride
        ca = dual_split or cin
        cb = cin - ca
        self.kernel = (policy.fused_eval and stride == 1
                       and block_ops.supports(ca, cb, co, self.proj))
        cdt = policy.compute_dtype
        convs = [("1", "conv1", "bn1"), ("2", "conv2", "bn2")]
        if self.proj:
            convs.append(("b", "bypass", "bnpass"))
        for tag, ck, bk in convs:
            w = sd[f"{pref}.{ck}.weight"].float()
            g, b = _affine(sd, f"{pref}.{ck}", f"{pref}.{bk}")
            if self.kernel:
                wk = w.permute(2, 3, 1, 0)
                if tag == "b":
                    wk = wk[0, 0]  # (cin, co)
                self.register_buffer(f"w{tag}", wk.to(device, cdt).contiguous())
                self.register_buffer(f"g{tag}", g.to(device))
                self.register_buffer(f"b{tag}", b.to(device))
            else:
                self.register_buffer(f"w{tag}", (w * g.view(-1, 1, 1, 1)).to(
                    device, cdt).contiguous(memory_format=torch.channels_last))
                self.register_buffer(f"b{tag}", b.to(device, cdt))

    def forward(self, x: torch.Tensor,
                dual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.kernel:
            if self.proj:
                return block_ops.basic_block(
                    x, dual, self.w1, self.g1, self.b1, self.w2, self.g2,
                    self.b2, self.wb, self.gb, self.bb)
            return block_ops.basic_block(x, dual, self.w1, self.g1, self.b1,
                                         self.w2, self.g2, self.b2)
        if dual is not None:
            x = torch.cat([x, dual], dim=-1)
        xc = _nchw(x)
        y = torch.relu(F.conv2d(xc, self.w1, self.b1, stride=self.stride,
                                padding=1))
        y = torch.relu(F.conv2d(y, self.w2, self.b2, padding=1))
        if self.proj:
            xc = F.conv2d(xc, self.wb, self.bb, stride=self.stride)
        return _nhwc(torch.relu(y + xc))


class DoubleResNet(nn.Module):
    """Two stacked BasicBlocks (res1 carries the stride / the dual
    input)."""

    def __init__(self, sd: StateDict, pref: str, *, stride: int = 1,
                 dual_split: int = 0, policy: Policy = Policy(),
                 device=None):
        super().__init__()
        self.res1 = BasicBlock(sd, f"{pref}.res1", stride=stride,
                               dual_split=dual_split, policy=policy,
                               device=device)
        self.res2 = BasicBlock(sd, f"{pref}.res2", policy=policy,
                               device=device)

    def forward(self, x, dual=None):
        return self.res2(self.res1(x, dual))


class Deconv2x(nn.Module):
    """torch ConvTranspose2d(k=4, s=2, p=1, bias=False) to a target
    size. Exact 2x runs on K3 when (ci, co) is compiled; other targets
    (the reference's ``output_size=skip.size()`` for odd shapes) run
    F.conv_transpose2d with output_padding and a high-side crop, which
    reproduces the JAX package's static padding for every target in
    [2d - 2, 2d + 1] (blocks.py Deconv2x)."""

    def __init__(self, sd: StateDict, key: str, *, policy: Policy = Policy(),
                 device=None):
        super().__init__()
        device = resolve_device(device)
        w = sd[f"{key}.weight"].float()  # IOHW
        ci, co = w.shape[:2]
        cdt = policy.compute_dtype
        self.kernel = policy.fused_eval and deconv_ops.supports(ci, co)
        self.register_buffer("w", w.to(device, cdt).contiguous())
        if self.kernel:
            self.register_buffer(
                "wk", w.permute(2, 3, 0, 1).to(device, cdt).contiguous())

    def forward(self, x: torch.Tensor,
                target_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        th, tw = target_hw if target_hw is not None else (2 * h, 2 * w)
        if self.kernel and (th, tw) == (2 * h, 2 * w):
            return deconv_ops.deconv2x(x, self.wk)
        ops = []
        for d, t in ((h, th), (w, tw)):
            if not 2 * d - 2 <= t <= 2 * d + 1:
                raise ValueError(f"deconv target size {t} unreachable from "
                                 f"input {d}")
            ops.append(max(0, t - 2 * d))
        y = F.conv_transpose2d(_nchw(x), self.w, stride=2, padding=1,
                               output_padding=tuple(ops))
        return _nhwc(y[:, :, :th, :tw])


class DecoderBlock(nn.Module):
    """Deconv 2x upsample → [up, skip] join → DoubleResNet."""

    def __init__(self, sd: StateDict, pref: str, *, policy: Policy = Policy(),
                 device=None):
        super().__init__()
        self.deconv = Deconv2x(sd, f"{pref}.deconv", policy=policy,
                               device=device)
        c_up = sd[f"{pref}.deconv.weight"].shape[1]
        self.res = DoubleResNet(sd, f"{pref}.res", dual_split=c_up,
                                policy=policy, device=device)

    def forward(self, x, skip):
        up = self.deconv(x, (skip.shape[1], skip.shape[2]))
        return self.res(up, dual=skip)


def stem_pool(x: torch.Tensor, fused: bool) -> torch.Tensor:
    """MaxPool2d(3, 2, 1) on NHWC; K4 when ``fused`` and the shape
    qualifies (ops/pool.py:supports)."""
    if fused and pool_ops.supports(x.shape[3], x.shape[1], x.shape[2]):
        return pool_ops.maxpool3x3s2(x)
    return _nhwc(F.max_pool2d(_nchw(x), 3, 2, 1))
