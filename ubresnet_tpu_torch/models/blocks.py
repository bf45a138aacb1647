"""Building blocks of the U-ResNet family, NHWC (counterpart of
ubresnet_tpu/models/blocks.py): the eval modules first, then their
train-mode counterparts (see "train mode" below).

Every eval module is built from a reference-format state_dict (the
``parity/torch_oracle.py`` key names) and prepares its weights once, at
construction, on its device (cuda unless ``device="cpu"`` is passed;
no card and no explicit cpu raises, utils/platform.py):

  * a layer that runs as a torch.nn.functional op (cuDNN on the card)
    keeps its conv weight with the eval BatchNorm (and conv bias)
    folded in, cast to the compute dtype, in channels-last form;
  * a layer that a Hopper kernel runs (ops/) keeps its kernel in the
    JAX layout (HWIO), cast to the compute dtype, and the folded BN as
    an f32 affine (g, b) for the kernel's epilogue.

Which of the two runs is the JAX package's choice, per call ("routes"
below): a layer of the JAX package's packed zone keeps both forms and
takes its kernel exactly where JAX calls a Pallas kernel — at the
flagship width the stem pool, enc1, dec2, dec1, the head and the
classifier; at inplanes 32 the same but dec2's upsample and the head —
whether or not an instance was compiled (ops/_build.py:SHAPES: on the
card the wrapper raises where none was). Nothing routes by catching a
failure.

Reference semantics kept (common_layers.py via the JAX package):
BasicBlock applies ReLU to the residual branch before the add and again
after it; BN eps is 1e-5; the decoder concat order is [up, skip].

QAT (``policy.quant_train``, ops/quant.py): a module built with
``qat=True`` is in the JAX package's packed zone and fake-quantizes its
input and kernel per call (the classifier its kernel only), as JAX's
eval passes do while QAT trains; its BN stays apart from the
fake-quantized kernel (K1's epilogue, or a compute-dtype affine after
the F.conv2d), and a BasicBlock leaves K2 for per-conv F.conv2d with
cb2's input fake-quantized in between (JAX keeps QAT off its
whole-block kernel for that reason).

int8 (``policy.quant_eval``, ops/quant.py): a module built with
``quant=True`` belongs to the int8 zone — the JAX package's packed zone
(stem, enc1, dec2, dec1, head). It keeps its raw conv weight (the BN is
NOT folded into it: int8 quantizes the raw kernel per output channel
and folds the BN into the gain, as JAX's ``fold_q``) until
``set_scales`` gets the calibrated activation scales; then it holds the
int8 weights and folded f32 gains and runs K1-s8 / K2-s8 / K3-s8
where JAX runs its fused int8 kernels (on the card a shape no kernel
was compiled for raises), or, where JAX leaves them (the 1-channel
stem, a stride-2 conv, channels too few to fill its lanes: its XLA
route), the exact integer conv in plain torch dequantized into the
BN. Before ``set_scales`` an int8 module raises. Every module also
reports its inputs to ``observer`` during calibration (``qname`` is the
layer's name in the JAX package's 'quant' collection, ``qpack`` the
W-packing factor its input has there).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as checkpoint_lib
from torch import nn

from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.ops import block as block_ops
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import deconv as deconv_ops
from ubresnet_tpu_torch.ops import pool as pool_ops
from ubresnet_tpu_torch.ops import quant as quant_ops
from ubresnet_tpu_torch.ops import train_conv as train_ops
from ubresnet_tpu_torch.parallel.sharding import psum, world_of
from ubresnet_tpu_torch.utils.platform import resolve_device

BN_EPS = 1e-5

StateDict = Dict[str, torch.Tensor]

NO_SCALES = ("quant_eval=True but no calibrated scales — run "
             "ubresnet_tpu_torch.ops.quant.calibrate and "
             "UResNet.set_quant_scales first")


def jax_name(key: str) -> Optional[str]:
    """The JAX package's module path of a reference layer prefix, as its
    'quant' collection names it: conv1 → stem, conv10 → head,
    enc_layer1.res1 → enc1.res1, dec_layer2.res.res1 → dec2.res.res1,
    dec_layer2.deconv → dec2.deconv, ASPP_layer_enc3.B1_conv → aspp3.b1,
    ASPP_combine_enc3.ASPP_conv → aspp3_post.post; None for the
    classifier (JAX's PackedConv records no scale)."""
    if key in ("conv1", "conv10"):
        return {"conv1": "stem", "conv10": "head"}[key]
    m = re.fullmatch(r"ASPP_layer_enc(\d+)\.B(\d+)_conv", key)
    if m:
        return f"aspp{m[1]}.b{m[2]}"
    m = re.fullmatch(r"ASPP_combine_enc(\d+)\.ASPP_conv", key)
    if m:
        return f"aspp{m[1]}_post.post"
    name = re.sub(r"^(enc|dec)_layer(\d+)", r"\1\2", key)
    return None if name == key else name


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in float64 when it is float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def fold_bn(scale, bias, mean, var, cbias=None, eps: float = BN_EPS):
    """BN (+ optional conv bias) → one f32 affine y = conv·g + b (f64
    for f64 inputs)."""
    g = _f32(scale) * torch.rsqrt(_f32(var) + eps)
    b = _f32(bias) - _f32(mean) * g
    if cbias is not None:
        b = b + g * _f32(cbias)
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


# ---------------------------------------------------------------- routes
#
# Where a layer runs its kernel: exactly where the JAX package, under
# its fused policy, calls a Pallas kernel, and nowhere else; where JAX
# leaves a layer to XLA, the layer is an F.conv2d / F.conv_transpose2d /
# F.max_pool2d (cuDNN on the card), even where an instance happens to be
# compiled. The gates are JAX's own (ubresnet_tpu/models/blocks.py at
# the lines named), on its lane geometry (a packed tensor's channels
# fill 128 lanes), for both dtypes:
#   conv_fuses      ConvBN use_fused / use_fused_q (blocks.py:357-369,
#                   457-465)
#   block_fuses     BasicBlock use_block / use_dual (blocks.py:567-614)
#   deconv_fuses    Deconv2x, bf16 and int8 (blocks.py:853-858, 883-887)
#   classifier_fuses  classifier_apply (blocks.py:1090-1099)
#   pool_fuses      stem_pool_packed (blocks.py:1053-1076)
#   conv_ad_fuses   the train zone, use_fused_train and PackedConv's
#                   fused_train branch (blocks.py:143-155, 416-422,
#                   through pallas_conv.py:conv_ad_supported)
#   deconv_ad_fuses the train-mode Deconv2x under fused_train_deconv
#                   (blocks.py:883-912, through
#                   pallas_conv.py:deconv_ad_supported)
# JAX's VMEM fit test (_block_fits, blocks.py:581-591: a whole-plane
# spatial input can overflow the TPU's scoped VMEM) has no counterpart:
# the card's kernels tile the plane, and their shared memory does not
# grow with it. JAX packs (and so fuses) only inside its packed zone —
# the stem, enc1, dec2, dec1 and the head of a depth-5 model, at input
# widths it can pack (uresnet.py:68-70): a module built with
# ``zone=True`` is in it, and a model's forward says per call whether
# the zone runs (``zone_active``). Each module's ``_fused_form`` is this
# predicate at its shape, input width and pack, whatever the dtype;
# where it holds, the layer calls its kernel's wrapper, which on the
# card launches the kernel or raises at a shape none was compiled for
# (ops/_build.py:SHAPES). There is no exception: the 8-channel streams
# of inplanes 8 and 4 take their kernels as the flagship's do.

LANES = 128  # the TPU's lane width, which JAX's gates fill
_ZONE = contextvars.ContextVar("ubresnet_packed_zone", default=True)

@contextlib.contextmanager
def zone_active(active: bool):
    """Within the block, whether the JAX package runs its packed zone
    for the forward in progress (a model's ``packed_zone(width)``): off,
    no layer fuses."""
    token = _ZONE.set(bool(active))
    try:
        yield
    finally:
        _ZONE.reset(token)


def lane_pack(c: int, width: Optional[int], pack: int) -> int:
    """The JAX package's lane-filling pack for a fused kernel over ``c``
    channels of an input ``width`` wide (blocks.py:_p_eff): 128/c when
    that is at most 16 and divides the width, else the stage's ``pack``.
    ``width`` None: a width it divides (every width the zone runs)."""
    pe = LANES // c if LANES % c == 0 else 0
    return (pe if pe and pe <= 16 and (width is None or width % pe == 0)
            else pack)


def conv_fuses(ci: int, k: int, width: Optional[int], pack: int) -> bool:
    """A stride-1 eval ConvBN's lane tests (bf16 and int8)."""
    return (_ZONE.get() and ci * lane_pack(ci, width, pack) >= LANES
            and 2 * (k // 2) * ci <= LANES)


def block_fuses(c_x: int, c_d: int, co: int, proj: bool,
                width: Optional[int], pack: int) -> bool:
    """A stride-1 eval BasicBlock over ``c_x`` channels (and a second
    stream of ``c_d``, the dual block, which needs the projection and
    equal streams), at the first stream's lane pack."""
    pe = lane_pack(c_x, width, pack)
    if not (_ZONE.get() and 2 * co <= LANES and co * pe >= LANES):
        return False
    if c_d:
        return proj and c_x == c_d and c_x * pe >= LANES and 2 * c_x <= LANES
    return c_x * pe >= LANES and 2 * c_x <= LANES


def deconv_fuses(ci: int, width: Optional[int], pack: int) -> bool:
    """An eval Deconv2x at an exact 2x target (bf16 and int8)."""
    return (_ZONE.get() and ci * lane_pack(ci, width, pack) >= LANES
            and 2 * ci <= LANES)


def classifier_fuses(ci: int, pack: int) -> bool:
    """The 7x7 classifier in eval: the head's pack ``pack`` (no lane
    re-view) fills the lanes and its halo fits them."""
    return _ZONE.get() and ci * pack >= LANES and 2 * 3 * ci <= LANES


def pool_fuses(c: int, h: int, w: int, pack: int) -> bool:
    """The stem pool (eval, and the train forward): the stem's pack
    fills exactly one lane tile and the packed plane has even sides."""
    return (_ZONE.get() and c * pack == LANES and h % 2 == 0
            and (w // pack) % 2 == 0)


def _pad_channels(co: int) -> int:
    """pallas_conv.py:_pad_channels: co, or the next power of two."""
    return co if LANES % co == 0 else 1 << (co - 1).bit_length()


def conv_ad_fuses(ci: int, co: int, k: int, width: Optional[int],
                  pack: int) -> bool:
    """A stride-1 train-zone conv, BN-fed or the classifier: every leg
    of JAX's differentiable conv fits its kernel (conv_ad_supported at
    the lane pack)."""
    if k % 2 == 0 or not _ZONE.get():
        return False
    p, r, cod = lane_pack(ci, width, pack), k // 2, _pad_channels(co)
    return (p * ci >= LANES and 2 * r * ci <= LANES and 2 * r * co <= LANES
            and (p * co >= LANES or (cod <= LANES and 2 * r * cod <= LANES)))


def deconv_ad_fuses(ci: int, co: int, width: Optional[int],
                    pack: int) -> bool:
    """A train-mode Deconv2x at an exact 2x target under
    fused_train_deconv: the input's lanes and halo pass as in eval, and
    every leg of JAX's differentiable deconv fits its kernel
    (deconv_ad_supported at the lane pack: dy's lanes in the 2p view and
    its halo)."""
    pe = lane_pack(ci, width, pack)
    return (_ZONE.get() and pe * ci >= LANES and 2 * ci <= LANES
            and 2 * pe * co >= LANES and 2 * co <= LANES)


def _whole(w: torch.Tensor, shard) -> torch.Tensor:
    """A weight whole: gathered over its model group when ``shard`` (a
    parallel/sharding.py:ModelShard) says it holds a slice."""
    return w if shard is None else shard.gather(w)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """Zero-copy channels-last NCHW view of a contiguous NHWC tensor."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


class ConvBN(nn.Module):
    """'same' conv (+bias) → eval BN → [ReLU]; ``bn_key=None`` drops the
    BN (the classifier). Runs on K1 (ops/conv.py) where the JAX package
    fuses it (``_fused_form``: in the packed zone, ``zone``, a stride-1,
    undilated conv whose lanes pass conv_fuses, or classifier_fuses for
    the classifier), else as one F.conv2d with BN folded into its weight
    and bias (a dilated conv, ASPP's branches, pads dilation·(k // 2)).
    A layer in the zone keeps both forms of its weights: which one runs
    is decided per call, from the input width.
    In the int8 zone: K1-s8 with the dequant and BN folded into its gain
    where JAX fuses (the same predicate), else the exact integer conv,
    ``acc·(sx·sw) + bias`` in f32, cast to the compute dtype, BN in the
    compute dtype (JAX's PackedBN), ReLU — the XLA route of
    blocks.py:400-414 (a ``stride`` other than 1 only there: a per-conv
    int8 block's first conv or projection at stride 2). Where JAX fuses,
    K1-s8's wrapper runs, which on the card raises at a shape it was not
    compiled for; ``kernel`` says whether the layer takes K1 or K1-s8 at
    the zone's widths."""

    def __init__(self, sd: StateDict, conv_key: str, bn_key: Optional[str],
                 *, act: bool = True, policy: Policy = Policy(), device=None,
                 quant: bool = False, qpack: int = 1, qat: bool = False,
                 dilation: int = 1, stride: int = 1, zone: bool = True):
        super().__init__()
        device = resolve_device(device)
        w = sd[f"{conv_key}.weight"].float()  # OIHW
        co, ci, k, _ = w.shape
        g, b = _affine(sd, conv_key, bn_key)
        cdt = policy.compute_dtype
        self.pad, self.act, self.cdt = dilation * (k // 2), act, cdt
        self.dilation, self.stride = dilation, stride
        self.shape = (ci, co, k)
        self.classifier = bn_key is None
        self.qname, self.qpack, self.observer = jax_name(conv_key), qpack, None
        self.quant = quant and policy.quant_eval
        # JAX's gate but for its lanes (``_fused_form``)
        self.fuse_ok = (policy.fused_eval and zone and stride == 1
                        and dilation == 1)
        # QAT: the input is fake-quantized where a BN follows (a ConvBN),
        # the kernel always
        self.qat = qat and policy.quant_train and not self.quant
        self.qat_input = self.qat and bn_key is not None
        self.pct = policy.quant_percentile
        if self.quant:
            if bn_key is None or dilation != 1:
                raise ValueError(f"{conv_key}: an int8 ConvBN needs its BN "
                                 "and dilation 1")
            self.kernel = self._fused_form(None)
            self._device = device
            # the raw HWIO kernel; for the fused epilogue (K1-s8's) the
            # BN folded with the conv bias, for JAX's XLA route the conv
            # bias and the BN apart (JAX's PackedBN)
            cbias = sd.get(f"{conv_key}.bias")
            self._qsrc = {"w": w.permute(2, 3, 1, 0).contiguous(), "g": g,
                          "b": b,
                          "cbias": None if cbias is None else cbias.float(),
                          "bn": fold_bn(sd[f"{bn_key}.weight"],
                                        sd[f"{bn_key}.bias"],
                                        sd[f"{bn_key}.running_mean"],
                                        sd[f"{bn_key}.running_var"])}
            return
        self.kernel = self._fused_form(None)
        wk = w.permute(2, 3, 1, 0)  # HWIO
        if self.qat:
            wk = quant_ops.fake_quant_weight(wk)
            self._qat_plain(sd, conv_key, bn_key, wk, device, cdt)
        else:
            self.register_buffer("w", (w * g.view(-1, 1, 1, 1)).to(
                device, cdt).contiguous(memory_format=torch.channels_last))
            self.register_buffer("b", b.to(device, cdt))
        if self.fuse_ok:  # K1's form: HWIO kernel, f32 affine
            self.register_buffer("wk", wk.to(device, cdt).contiguous())
            self.register_buffer("gk", g.to(device))
            self.register_buffer("bk", b.to(device))

    def _qat_plain(self, sd, conv_key, bn_key, wq, device, cdt) -> None:
        """The F.conv2d route under QAT: the fake-quantized kernel and
        the conv bias, then the BN as its own affine in the compute
        dtype (JAX's PackedConv then PackedBN)."""
        self.register_buffer("w", wq.permute(3, 2, 0, 1).to(device, cdt)
                             .contiguous(memory_format=torch.channels_last))
        cbias = sd.get(f"{conv_key}.bias")
        self.register_buffer("cbias", None if cbias is None
                             else cbias.float().to(device, cdt))
        self.register_buffer("gbn", None)
        self.register_buffer("bbn", None)
        if bn_key is not None:
            g, b = fold_bn(sd[f"{bn_key}.weight"], sd[f"{bn_key}.bias"],
                           sd[f"{bn_key}.running_mean"],
                           sd[f"{bn_key}.running_var"])
            self.gbn, self.bbn = g.to(device, cdt), b.to(device, cdt)

    def set_scales(self, scales: Dict[str, torch.Tensor]) -> None:
        """Quantize the kernel and fold the dequant (f32, in JAX's
        order) once, from this layer's calibrated input scale."""
        src, dev = self._qsrc, self._device
        sx = scales[self.qname].float()
        sw = quant_ops.weight_scales(src["w"])
        self.register_buffer("sx", sx.to(dev))
        self.register_buffer("wq", quant_ops.quantize_weight(src["w"], sw)
                             .to(dev))
        # the fused epilogue, blocks.py:381-386: g·sw·sx, beta
        self.register_buffer("g", (src["g"] * sw * sx).to(dev))
        self.register_buffer("b", src["b"].to(dev))
        g, b = src["bn"]  # the XLA route, blocks.py:407-411
        self.register_buffer("gq", (sx * sw).to(dev))
        self.register_buffer("cbias", None if src["cbias"] is None
                             else src["cbias"].to(dev))
        self.register_buffer("gbn", g.to(dev, self.cdt))
        self.register_buffer("bbn", b.to(dev, self.cdt))

    def _fused_form(self, width: Optional[int]) -> bool:
        """Whether JAX runs this conv in its fused kernel at this input
        width (None: at the zone's widths), either dtype."""
        if not self.fuse_ok:
            return False
        ci, _, k = self.shape
        if self.classifier:
            return classifier_fuses(ci, self.qpack)
        return conv_fuses(ci, k, width, self.qpack)

    def _forward_int8(self, x: torch.Tensor,
                      residual: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """``residual``: a per-conv block's tail — relu(y + residual)
        after this conv's ReLU, in the epilogue of the fused form
        (float32) as JAX's fused_packed_conv adds it, after the cast on
        the XLA route (blocks.py:388-395, 412-414)."""
        if not hasattr(self, "sx"):
            raise ValueError(NO_SCALES)
        xq = quant_ops.quantize_act(x, self.sx)
        if self._fused_form(x.shape[2]):
            # JAX's fused int8 conv: K1-s8, whose wrapper raises on the
            # card at a shape it was not compiled for
            tail = residual is not None
            return conv_ops.conv_bn_act_s8(
                xq, self.wq, self.g, self.b, residual,
                pre_act=self.act and tail, act=self.act or tail,
                out_dtype=self.cdt)
        acc = quant_ops.int_conv2d(xq, self.wq, self.pad, self.stride)
        # dequant (+ conv bias), cast, BN: each affine one FMA, as XLA
        # compiles blocks.py:407-411
        y = (acc * self.gq if self.cbias is None
             else quant_ops.fma(acc, self.gq, self.cbias))
        y = quant_ops.fma(y.to(self.cdt), self.gbn, self.bbn).to(self.cdt)
        if self.act:
            y = torch.relu(y)
        if residual is not None:
            y = torch.relu(y + residual)
        return y.contiguous()

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.observer is not None and self.qname is not None:
            self.observer(self.qname, x, self.qpack)
        if self.quant:
            return self._forward_int8(x, residual)
        if self.qat_input:
            x = quant_ops.fake_quant_act(x, self.pct, self.qpack)
        if self._fused_form(x.shape[2]):
            return conv_ops.conv_bn_act(x, self.wk, self.gk, self.bk,
                                        act=self.act)
        return self.plain(x)

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        """The F.conv2d route (bf16 or f32, with or without QAT)."""
        if self.qat:
            y = F.conv2d(_nchw(x), self.w, self.cbias, padding=self.pad,
                         dilation=self.dilation, stride=self.stride)
            if self.gbn is not None:
                y = y * self.gbn.view(1, -1, 1, 1) + self.bbn.view(1, -1, 1, 1)
        else:
            y = F.conv2d(_nchw(x), self.w, self.b, padding=self.pad,
                         dilation=self.dilation, stride=self.stride)
        if self.act:
            y = torch.relu(y)
        return _nhwc(y)


class BasicBlock(nn.Module):
    """Two 3x3 conv-BN-ReLU + bypass (1x1 conv-BN projection when the
    channels or the stride change), pre-add ReLU, add, ReLU.

    ``dual_split``: the block's input is the channel concat of two
    streams and the first ``dual_split`` channels come from the first
    (the decoder's [up, skip] join); ``forward(x, dual=skip)``. On K2
    the concat never materialises; the per-conv routes concatenate.

    Where the JAX package runs its whole-block kernel (``_fused_form``:
    in the packed zone, ``zone``, stride 1, block_fuses on the first
    stream's lane geometry), the block calls K2's wrapper (bf16) or
    K2-s8's (int8); on the card the wrapper launches the kernel or
    raises at a (ca, cb, co, projection) none was compiled for. Where
    JAX leaves the whole block, a block in the zone runs per conv as
    JAX's does: ConvBNs cb1, bypass and cb2 (each taking K1 or K1-s8
    where JAX fuses that conv, by the same rule, else its XLA route),
    cb2 carrying the block's tail. Outside the zone (enc2-5, dec3-5) the
    block is three F.conv2d with the BN folded into their weights.

    int8 (blocks.py:643-704, 737-750): both streams quantized with cb1's
    scale sx1, m requantized on chip on cb2's grid s_mid, the identity
    bypass dequantized as sx1·xq; per conv, each int8 ConvBN quantizes
    its input with its own calibrated scale (JAX's 'quant' names
    ``<block>.cb1`` / ``.bypass`` / ``.cb2``), an exact integer conv,
    ``sx·sw`` folded into its affine — JAX's XLA route, not a stand-in
    for a kernel. ``kernel``: the block takes K2 or K2-s8 at the zone's
    widths (at inplanes 4 JAX runs enc1.res1 and dec1's blocks per
    conv).

    Under QAT (``qat``) the block runs per conv: ConvBNs cb1, bypass and
    cb2, each fake-quantizing its own input, never K2."""

    def __init__(self, sd: StateDict, pref: str, *, stride: int = 1,
                 dual_split: int = 0, policy: Policy = Policy(),
                 device=None, quant: bool = False, qpack: int = 1,
                 qat: bool = False, zone: bool = True):
        super().__init__()
        device = resolve_device(device)
        w1 = sd[f"{pref}.conv1.weight"].float()
        co, cin = w1.shape[:2]
        self.proj = f"{pref}.bypass.weight" in sd
        self.stride = stride
        ca = dual_split or cin
        cb = cin - ca
        self.shape = (ca, cb, co, self.proj)
        self.qname, self.qpack, self.observer = jax_name(pref), qpack, None
        self.quant = quant and policy.quant_eval
        cdt = policy.compute_dtype
        convs = [("1", "conv1", "bn1"), ("2", "conv2", "bn2")]
        if self.proj:
            convs.append(("b", "bypass", "bnpass"))
        self.qat = qat and policy.quant_train and not self.quant
        # JAX's fused_ok (blocks.py:567-578) but for the lane tests
        self.fuse_ok = (policy.fused_eval and zone and stride == 1
                        and not policy.quant_train)
        self.kernel = self._fuses(ca, cb, None)
        self.cb = None

        def build_per_conv(pol, **kw):  # cb1, cb2 and bypass as ConvBNs
            self.cb = nn.ModuleDict({
                tag: ConvBN(sd, f"{pref}.{ck}", f"{pref}.{bk}",
                            act=tag != "b", policy=pol, device=device,
                            qpack=qpack, zone=zone,
                            stride=1 if tag == "2" else stride, **kw)
                for tag, ck, bk in convs})
            for tag, name in (("1", "cb1"), ("2", "cb2"), ("b", "bypass")):
                if tag in self.cb:  # JAX's 'quant' collection names
                    self.cb[tag].qname = f"{self.qname}.{name}"

        if self.qat:
            build_per_conv(dataclasses.replace(policy, fused_eval=False),
                           qat=True)
            return
        if self.quant:
            self.cdt, self._device = cdt, device
            self._qsrc = {
                tag: (sd[f"{pref}.{ck}.weight"].float().permute(2, 3, 1, 0)
                      .contiguous(),
                      *_affine(sd, f"{pref}.{ck}", f"{pref}.{bk}"))
                for tag, ck, bk in convs}
            build_per_conv(policy, quant=True)
            return
        if zone:
            build_per_conv(policy)
        for tag, ck, bk in convs:
            w = sd[f"{pref}.{ck}.weight"].float()
            g, b = _affine(sd, f"{pref}.{ck}", f"{pref}.{bk}")
            if self.fuse_ok:  # K2's form: JAX layouts, f32 affines
                wk = w.permute(2, 3, 1, 0)
                if tag == "b":
                    wk = wk[0, 0]  # (cin, co)
                self.register_buffer(f"w{tag}", wk.to(device, cdt).contiguous())
                self.register_buffer(f"g{tag}", g.to(device))
                self.register_buffer(f"b{tag}", b.to(device))
            elif not zone:  # three folded F.conv2d
                self.register_buffer(f"w{tag}", (w * g.view(-1, 1, 1, 1)).to(
                    device, cdt).contiguous(memory_format=torch.channels_last))
                self.register_buffer(f"b{tag}", b.to(device, cdt))

    def set_scales(self, scales: Dict[str, torch.Tensor]) -> None:
        """int8 weights and folded gains from cb1's and cb2's calibrated
        input scales (JAX's fold_q, f32, in its order); per conv, each
        ConvBN's from its own as well."""
        for cb in self.cb.values():
            cb.set_scales(scales)
        sx1 = scales[f"{self.qname}.cb1"].float()
        s_mid = scales[f"{self.qname}.cb2"].float()

        def fold_q(tag, s_in, s_out=None):
            w, g, beta = self._qsrc[tag]
            g = g * (s_in * quant_ops.weight_scales(w))
            if s_out is not None:
                g, beta = g / s_out, beta / s_out
            return quant_ops.quantize_weight(w, quant_ops.weight_scales(w)), \
                g, beta

        params = {"sx": sx1}
        params["w1"], params["g1"], params["b1"] = fold_q("1", sx1, s_mid)
        params["w2"], params["g2"], params["b2"] = fold_q("2", s_mid)
        if self.proj:
            wb, params["gb"], params["bb"] = fold_q("b", sx1)
            params["wb"] = wb[0, 0].contiguous()  # (cin, co)
        else:  # identity bypass: dequant sx1·xq + 0
            co = params["g1"].shape[0]
            params["gb"] = sx1 * torch.ones(co)
            params["bb"] = torch.zeros(co)
        for name, t in params.items():
            self.register_buffer(name, t.to(self._device))

    def _fuses(self, c_x: int, c_d: int, width: Optional[int]) -> bool:
        return self.fuse_ok and block_fuses(c_x, c_d, self.shape[2],
                                            self.proj, width, self.qpack)

    def _fused_form(self, x, dual) -> bool:
        """Whether JAX runs this block in its whole-block kernel at these
        inputs (either dtype)."""
        return self._fuses(x.shape[-1], 0 if dual is None else dual.shape[-1],
                           x.shape[2])

    def _per_conv(self, x, dual, tail: bool = False):
        """cb2(cb1(x)) with the bypass: JAX's per-ConvBN route; ``tail``:
        cb2 adds it in its epilogue (int8), else relu(cb2 + bypass)."""
        if dual is not None:
            x = torch.cat([x, dual], dim=-1)
        r = self.cb["b"](x) if self.proj else x
        if tail:
            return self.cb["2"](self.cb["1"](x), residual=r)
        return torch.relu(self.cb["2"](self.cb["1"](x)) + r)

    def forward(self, x: torch.Tensor,
                dual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.qat:
            return self._per_conv(x, dual)
        fused = self._fused_form(x, dual)
        if self.quant:
            if not hasattr(self, "sx"):
                raise ValueError(NO_SCALES)
            if not fused:
                return self._per_conv(x, dual, tail=True)
            # K2-s8; where JAX fuses a block it was not compiled for, its
            # wrapper raises on the card
            return block_ops.basic_block_s8(
                quant_ops.quantize_act(x, self.sx),
                None if dual is None else quant_ops.quantize_act(dual,
                                                                 self.sx),
                self.w1, self.g1, self.b1, self.w2, self.g2, self.b2,
                self.wb if self.proj else None, self.gb, self.bb,
                out_dtype=self.cdt)
        if fused:
            if self.proj:
                return block_ops.basic_block(
                    x, dual, self.w1, self.g1, self.b1, self.w2, self.g2,
                    self.b2, self.wb, self.gb, self.bb)
            return block_ops.basic_block(x, dual, self.w1, self.g1, self.b1,
                                         self.w2, self.g2, self.b2)
        if self.cb is not None:
            return self._per_conv(x, dual)
        if dual is not None:
            x = torch.cat([x, dual], dim=-1)
        observe = self.observer
        if observe is not None:  # calibration: cb1's (and bypass's) input
            observe(f"{self.qname}.cb1", x, self.qpack)
            if self.proj:
                observe(f"{self.qname}.bypass", x, self.qpack)
        xc = _nchw(x)
        y = torch.relu(F.conv2d(xc, self.w1, self.b1, stride=self.stride,
                                padding=1))
        if observe is not None:  # cb2's input: conv1's post-ReLU output
            observe(f"{self.qname}.cb2", _nhwc(y), self.qpack)
        y = torch.relu(F.conv2d(y, self.w2, self.b2, padding=1))
        if self.proj:
            xc = F.conv2d(xc, self.wb, self.bb, stride=self.stride)
        return _nhwc(torch.relu(y + xc))


class DoubleResNet(nn.Module):
    """Two stacked BasicBlocks (res1 carries the stride / the dual
    input)."""

    def __init__(self, sd: StateDict, pref: str, *, stride: int = 1,
                 dual_split: int = 0, policy: Policy = Policy(),
                 device=None, quant: bool = False, qpack: int = 1,
                 qat: bool = False, zone: bool = True):
        super().__init__()
        kw = dict(policy=policy, device=device, quant=quant, qpack=qpack,
                  qat=qat, zone=zone)
        self.res1 = BasicBlock(sd, f"{pref}.res1", stride=stride,
                               dual_split=dual_split, **kw)
        self.res2 = BasicBlock(sd, f"{pref}.res2", **kw)

    def forward(self, x, dual=None):
        return self.res2(self.res1(x, dual))


class Deconv2x(nn.Module):
    """torch ConvTranspose2d(k=4, s=2, p=1, bias=False) to a target
    size. An exact 2x target runs on K3 where the JAX package fuses it
    (``_fused_form``: in the packed zone, ``zone``, deconv_fuses on its
    input's lane geometry); other targets (the reference's
    ``output_size=skip.size()`` for odd shapes), and layers JAX leaves to
    XLA, run F.conv_transpose2d with output_padding and a high-side
    crop, which reproduces the JAX package's static padding for every
    target in [2d - 2, 2d + 1] (blocks.py Deconv2x). In the int8 zone:
    K3-s8 with the dequant sx·sw where JAX runs its fused int8 deconv
    (the same predicate, blocks.py:855-866; on the card the wrapper
    raises at a shape it was not compiled for; ``kernel`` says whether
    the layer takes K3 or K3-s8 at the zone's widths); elsewhere, as JAX leaves its fused kernel, the exact
    integer deconv (ops/quant.py:int_conv_transpose2d) to any target, as
    ``deconv_to`` reaches it, times sx·sw in f32, cast to the compute
    dtype — JAX's packed_deconv2x route (blocks.py:867-873). Under QAT
    the input and the kernel are fake-quantized before either route."""

    def __init__(self, sd: StateDict, key: str, *, policy: Policy = Policy(),
                 device=None, quant: bool = False, qpack: int = 1,
                 qat: bool = False, zone: bool = True):
        super().__init__()
        device = resolve_device(device)
        w = sd[f"{key}.weight"].float()  # IOHW
        ci, co = w.shape[:2]
        self.shape = (ci, co)
        cdt = policy.compute_dtype
        self.qname, self.qpack, self.observer = jax_name(key), qpack, None
        self.quant = quant and policy.quant_eval
        self.qat = qat and policy.quant_train and not self.quant
        self.pct = policy.quant_percentile
        self.fuse_ok = policy.fused_eval and zone
        if self.quant:
            self.kernel = self._fused_form(None)
            self.cdt, self._device = cdt, device
            self._qsrc = w.permute(2, 3, 0, 1).contiguous()  # (4, 4, ci, co)
            return
        self.kernel = self._fused_form(None)
        if self.qat:
            w = quant_ops.fake_quant_weight(w.permute(2, 3, 0, 1)).permute(
                2, 3, 0, 1)
        self.register_buffer("w", w.to(device, cdt).contiguous())
        if self.fuse_ok:
            self.register_buffer(
                "wk", w.permute(2, 3, 0, 1).to(device, cdt).contiguous())

    def set_scales(self, scales: Dict[str, torch.Tensor]) -> None:
        """int8 kernel and the dequant vector sw·sx (blocks.py:849-866)."""
        sx = scales[self.qname].float()
        sw = quant_ops.weight_scales(self._qsrc)
        self.register_buffer("sx", sx.to(self._device))
        self.register_buffer("wq", quant_ops.quantize_weight(self._qsrc, sw)
                             .to(self._device))
        self.register_buffer("g", (sw * sx).to(self._device))

    def _fused_form(self, width: Optional[int]) -> bool:
        """Whether JAX runs this deconv in its fused kernel at this input
        width (at an exact 2x target; None: at the zone's widths), either
        dtype."""
        return self.fuse_ok and deconv_fuses(self.shape[0], width,
                                             self.qpack)

    def forward(self, x: torch.Tensor,
                target_hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if self.observer is not None:
            self.observer(self.qname, x, self.qpack)
        if self.qat:
            x = quant_ops.fake_quant_act(x, self.pct, self.qpack)
        h, w = x.shape[1], x.shape[2]
        th, tw = target_hw if target_hw is not None else (2 * h, 2 * w)
        fused = (th, tw) == (2 * h, 2 * w) and self._fused_form(w)
        if self.quant:
            if not hasattr(self, "sx"):
                raise ValueError(NO_SCALES)
            xq = quant_ops.quantize_act(x, self.sx)
            if fused:
                return deconv_ops.deconv2x_s8(xq, self.wq, self.g,
                                              out_dtype=self.cdt)
            acc = quant_ops.int_conv_transpose2d(xq, self.wq, (th, tw))
            return (acc * self.g).to(self.cdt)
        if fused:
            return deconv_ops.deconv2x(x, self.wk)
        return deconv_to(x, self.w, (th, tw))


def deconv_to(x: torch.Tensor, w: torch.Tensor,
              target_hw: Tuple[int, int]) -> torch.Tensor:
    """ConvTranspose2d(k=4, s=2, p=1) of NHWC ``x`` with IOHW ``w`` to
    ``target_hw``: output_padding and a high-side crop reach every
    target in [2d - 2, 2d + 1], as the JAX package's static padding."""
    h, w_in = x.shape[1], x.shape[2]
    th, tw = target_hw
    ops = []
    for d, t in ((h, th), (w_in, tw)):
        if not 2 * d - 2 <= t <= 2 * d + 1:
            raise ValueError(f"deconv target size {t} unreachable from "
                             f"input {d}")
        ops.append(max(0, t - 2 * d))
    y = F.conv_transpose2d(_nchw(x), w, stride=2, padding=1,
                           output_padding=tuple(ops))
    return _nhwc(y[:, :, :th, :tw])


class DecoderBlock(nn.Module):
    """Deconv 2x upsample → [up, skip] join → DoubleResNet."""

    def __init__(self, sd: StateDict, pref: str, *, policy: Policy = Policy(),
                 device=None, quant: bool = False, qpack: int = 1,
                 qat: bool = False, zone: bool = True):
        super().__init__()
        kw = dict(policy=policy, device=device, quant=quant, qpack=qpack,
                  qat=qat, zone=zone)
        self.deconv = Deconv2x(sd, f"{pref}.deconv", **kw)
        c_up = sd[f"{pref}.deconv.weight"].shape[1]
        self.res = DoubleResNet(sd, f"{pref}.res", dual_split=c_up, **kw)

    def forward(self, x, skip):
        up = self.deconv(x, (skip.shape[1], skip.shape[2]))
        return self.res(up, dual=skip)


# ASPP's branches (ASPP_ResNet.py:188-263, JAX blocks.py ASPP): the
# reference's name and the dilation; the kernel (1x1 for B1, else 3x3)
# comes with the weight
ASPP_BRANCHES = (("B1", 1), ("B2", 1), ("B3", 3), ("B4", 5))


def aspp_pool(x: torch.Tensor) -> torch.Tensor:
    """ASPP's fifth branch: MaxPool2d(3, 1, 1) of NHWC ``x``, channels
    kept."""
    return _nhwc(F.max_pool2d(_nchw(x), 3, 1, 1))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling over ``pref`` (the reference's
    ``ASPP_layer_enc{i}``): four biased conv-BN-ReLU branches — 1x1,
    3x3, 3x3 at dilation 3, 3x3 at dilation 5 — and the 3x3 stride-1
    max pool of the input cast to their dtype, concatenated in that
    order. All F.conv2d (cuDNN on the card), as XLA convs in JAX."""

    def __init__(self, sd: StateDict, pref: str, *, policy: Policy = Policy(),
                 device=None):
        super().__init__()
        self.branches = nn.ModuleList(
            ConvBN(sd, f"{pref}.{b}_conv", f"{pref}.{b}_bn", dilation=d,
                   policy=policy, device=device, zone=False)
            for b, d in ASPP_BRANCHES)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [branch(x) for branch in self.branches]
        return torch.cat(outs + [aspp_pool(x).to(outs[0].dtype)], dim=-1)


class ASPPCombine(ConvBN):
    """ASPP's 1x1 conv-BN-ReLU recompression over ``pref`` (the
    reference's ``ASPP_combine_enc{i}``)."""

    def __init__(self, sd: StateDict, pref: str, *, policy: Policy = Policy(),
                 device=None):
        super().__init__(sd, f"{pref}.ASPP_conv", f"{pref}.ASPP_bn",
                         policy=policy, device=device, zone=False)


def stem_pool(x: torch.Tensor, fused: bool, pack: int,
              train: bool = False) -> torch.Tensor:
    """MaxPool2d(3, 2, 1) on NHWC; K4 where the JAX package runs its
    Pallas pool (``fused`` and pool_fuses at the stem's ``pack``) —
    under autograd with the dense first-match backward when ``train``."""
    if fused and pool_fuses(x.shape[3], x.shape[1], x.shape[2], pack):
        if train:
            return pool_ops.maxpool3x3s2_ad(x)
        return pool_ops.maxpool3x3s2(x)
    return _nhwc(F.max_pool2d(_nchw(x), 3, 2, 1))


# ------------------------------------------------------------ train mode
#
# Trainable counterparts of the blocks above: f32 nn.Parameters and
# BN running-stat buffers under the reference key names, so a module's
# state_dict() is a reference state_dict. The eval modules above keep
# folding the BN at construction; these fold it per call (fold_bn) from
# the batch statistics (train) or the running ones (eval).
#
# Kernel routing, as in the eval model, where the JAX package fuses
# (conv_ad_fuses, per call): a conv of the packed zone (``zone``),
# stride 1, whose every leg fits JAX's differentiable conv, runs
# ops/train_conv.py (K5, with K1 for dx and K6 for dW) when it feeds a
# BN, ops/conv.py:conv_ad (K1, K1, K6) when not (the classifier); their
# wrappers raise on the card at a shape none was compiled for. At
# inplanes 16 (and 8 and 4) that is enc1, dec2, dec1, conv10 and
# conv11; at 32 the same but dec2's first conv and conv10, whose halos
# overflow the lanes. A decoder upsample of the packed zone (``zone``:
# dec2 and dec1) runs ops/deconv.py:deconv2x_ad (K3 forward, K10 dx and
# dW) where JAX runs pallas_deconv2x_ad: ``policy.fused_train_deconv``
# is set, its target is exactly 2x and deconv_ad_fuses holds on its
# lane geometry (per call). That is dec2 (64, 32) and dec1 (32, 16) at
# inplanes 16, dec1 (64, 32) at 32 (dec2's 128 input channels overflow
# the halo), dec2 (32, 16) and dec1 (16, 8) at 8, dec2 (16, 8) and
# dec1 (8, 4) at 4 — never a layer outside the zone, whatever was
# compiled; deconv2x_ad's wrappers raise on the card at a shape none
# was. Other layers are torch.nn.functional ops under autograd, as they
# are XLA in JAX.
#
# QAT (``policy.quant_train``): a module built with ``qat=True`` is in
# the JAX package's packed zone (stem, enc1, dec2, dec1, head and the
# classifier) and fake-quantizes (ops/quant.py) what JAX's does there:
# every ConvBN's input and kernel, the classifier's kernel only, the
# deconv's input and kernel; ``qpack`` is the W-packing factor JAX's
# tensor has there, which shapes a percentile's subsample.
#
# The model axis (parallel/sharding.py:shard_state): a Conv or
# TrainDeconv2x whose weight is sharded by output channel holds this
# rank's slice (``model_shard``). On the F.conv2d / F.conv_transpose2d
# route it computes those output channels and all-gathers them over the
# model group (its input's gradient summed over the group), the bias
# after the gather; a kernel route (and QAT's fake-quantized kernel)
# gathers the weight whole first, so routes and launches do not change.
#
# Remat (``remat``): a module call whose activations backward recomputes
# (torch.utils.checkpoint) instead of keeping them, as jax.checkpoint /
# nn.remat do in JAX. The recompute runs the forward again, and a
# train-mode BatchNorm updates its running stats in place, so the
# recompute freezes them (``frozen_stats``): each step still moves them
# once, as JAX's functional BN does.

BN_DECAY = 0.9  # running-average decay (flax momentum; torch's 0.1)


class Conv(nn.Module):
    """A reference Conv2d's parameters — ``weight`` (co, ci, k, k) and
    optional ``bias``, f32 — and its train-mode forward. ``bn``: the
    conv feeds a BatchNorm, so the zone form is K5 with its statistics
    (``with_stats``, which also fake-quantizes the input under QAT);
    otherwise it is conv_ad + bias (``forward``). Which form runs is the
    JAX package's choice per call (``_fused_form``); ``zone`` says
    whether the conv is in the train zone at the zone's widths. A
    ``dilation`` other than 1 (ASPP's branches) is never in the zone."""

    def __init__(self, sd: StateDict, key: str, *, stride: int = 1,
                 bn: bool = True, policy: Policy = Policy(), device=None,
                 qat: bool = False, qpack: int = 1, dilation: int = 1,
                 zone: bool = True):
        super().__init__()
        device = resolve_device(device)
        w = sd[f"{key}.weight"].float()
        co, ci, k, _ = w.shape
        self.weight = nn.Parameter(w.to(device).clone())
        b = sd.get(f"{key}.bias")
        self.bias = (nn.Parameter(b.float().to(device).clone())
                     if b is not None else None)
        self.stride, self.pad = stride, dilation * (k // 2)
        self.dilation = dilation
        self.cdt = policy.compute_dtype
        self.qat = qat and policy.quant_train
        self.qpack, self.pct = qpack, policy.quant_percentile
        self.shape = (ci, co, k)
        self.route = "conv_stats" if bn else "conv_ad"
        self.fuse_ok = (policy.fused_train and zone and stride == 1
                        and dilation == 1)
        self.zone = self._fused_form(None)
        # the model axis (parallel/sharding.py:shard_state): ``weight``
        # holds this rank's output channels
        self.model_shard = None

    def _fused_form(self, width: Optional[int]) -> bool:
        """Whether JAX runs this conv on its train-zone kernels at this
        input width (None: at the zone's widths)."""
        return self.fuse_ok and conv_ad_fuses(*self.shape, width, self.qpack)

    def _kernel_weight(self) -> torch.Tensor:
        """(k, k, ci, co) in the compute dtype, under autograd
        (fake-quantized under QAT), whole: a sharded weight is gathered
        over its model group first, as XLA gathers a Pallas call's
        operands."""
        w = _whole(self.weight, self.model_shard).permute(2, 3, 1, 0)
        if self.qat:
            w = quant_ops.fake_quant_weight(w)
        return w.to(self.cdt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.route == "conv_ad" and self._fused_form(x.shape[2]):
            y = conv_ops.conv_ad(x, self._kernel_weight())
            return y if self.bias is None else y + self.bias.to(y.dtype)
        b = None if self.bias is None else self.bias.to(self.cdt)
        shard = self.model_shard
        if shard is not None and not self.qat:
            # this rank's output channels, gathered over the model group;
            # the bias acts on the gathered tensor
            y = shard.gather(_nhwc(F.conv2d(
                _nchw(shard.enter(x)), self.weight.to(self.cdt), None,
                stride=self.stride, padding=self.pad,
                dilation=self.dilation)), dim=-1)
            return y if b is None else y + b
        w = (self._kernel_weight().permute(3, 2, 0, 1) if self.qat
             else self.weight.to(self.cdt))
        return _nhwc(F.conv2d(_nchw(x), w, b, stride=self.stride,
                              padding=self.pad, dilation=self.dilation))

    def with_stats(self, x: torch.Tensor):
        """(y, (Σy, Σy²)) from K5 in the zone, else (y, None)."""
        if self.qat:
            x = quant_ops.fake_quant_act(x, self.pct, self.qpack)
        if self.route == "conv_stats" and self._fused_form(x.shape[2]):
            y, s1, s2 = train_ops.train_conv_stats(x, self._kernel_weight(),
                                                   self.bias)
            return y, (s1, s2)
        return self(x), None


class BatchNorm(nn.Module):
    """A reference BatchNorm2d: ``weight``/``bias`` parameters and the
    ``running_mean``/``running_var`` buffers, f32. Training: batch
    moments mean = Σy/n, var = Σy²/n − mean² (f32, clipped at 0 as
    flax's BatchNorm does), from K5's sums when given, else from torch
    reductions of y in the same form; running stats ← 0.9·running +
    0.1·batch with the biased var. Eval: the running stats. Normalises
    through fold_bn in the compute dtype.

    Data-parallel (``data_group``, set by parallel/sharding.py:
    shard_state): the moments are the global batch's, as JAX's under
    GSPMD — K5's (Σy, Σy²) or the plain (mean, E[y²]) of the rank's
    shard, stacked into one tensor, summed over the group by the
    differentiable ``psum`` (its backward sums the cotangents, through
    K5's VJP too) and divided by the ranks' total (every rank holds an
    equal shard, so n·W, or W for the moments). Every rank then
    normalises and updates its running stats with the same values. With
    one rank the reduction is the identity and the arithmetic is the
    single-process one."""

    def __init__(self, sd: StateDict, key: str, *, policy: Policy = Policy(),
                 device=None):
        super().__init__()
        device = resolve_device(device)
        def own(name):  # a copy: training must not write the caller's sd
            return sd[f"{key}.{name}"].float().to(device).clone()

        self.weight = nn.Parameter(own("weight"))
        self.bias = nn.Parameter(own("bias"))
        self.register_buffer("running_mean", own("running_mean"))
        self.register_buffer("running_var", own("running_var"))
        self.cdt = policy.compute_dtype
        self.update_stats = True  # off while a remat recompute runs
        self.data_group = None

    def forward(self, y: torch.Tensor, stats=None) -> torch.Tensor:
        if self.training:
            group = self.data_group
            if stats is None:
                yf = _f32(y)
                mean = yf.mean((0, 1, 2))
                e2 = (yf * yf).mean((0, 1, 2))
                if group is not None:
                    mean, e2 = psum(torch.stack([mean, e2]),
                                    group) / world_of(group)
                var = e2 - mean * mean
            else:
                n = y.numel() // y.shape[-1]
                s1, s2 = stats
                if group is not None:
                    s1, s2 = psum(torch.stack([s1, s2]), group)
                    n *= world_of(group)
                mean = s1 / n
                var = s2 / n - mean * mean
            var = var.clamp_min(0.0)
            if self.update_stats:
                with torch.no_grad():
                    self.running_mean.copy_(BN_DECAY * self.running_mean
                                            + (1 - BN_DECAY) * mean)
                    self.running_var.copy_(BN_DECAY * self.running_var
                                           + (1 - BN_DECAY) * var)
        else:
            mean, var = self.running_mean, self.running_var
        g, b = fold_bn(self.weight, self.bias, mean, var)
        return y.to(self.cdt) * g.to(self.cdt) + b.to(self.cdt)


@contextlib.contextmanager
def frozen_stats(module: nn.Module):
    """Every BatchNorm under ``module`` leaves its running stats alone
    inside the block."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_stats = s


@contextlib.contextmanager
def _both(a, b):
    with a, b:
        yield


def remat(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` with its activations recomputed in
    backward (torch.utils.checkpoint, non-reentrant) and its BatchNorms'
    running stats frozen during the recompute. The recompute runs the
    whole forward (no early stop), so its kernels launch again, each
    once."""
    active = _ZONE.get()  # the recompute routes as this forward does

    def contexts():
        return contextlib.nullcontext(), _both(frozen_stats(module),
                                               zone_active(active))

    with checkpoint_lib.set_checkpoint_early_stop(False):
        return checkpoint_lib.checkpoint(module, *args, use_reentrant=False,
                                         context_fn=contexts, **kwargs)


def conv_bn(conv: Conv, bn: BatchNorm, x: torch.Tensor, *,
            act: bool) -> torch.Tensor:
    """Train-mode ConvBN: conv → BN (batch statistics) → [ReLU]."""
    y, stats = conv.with_stats(x)
    y = bn(y, stats)
    return torch.relu(y) if act else y


class TrainBasicBlock(nn.Module):
    """Train-mode BasicBlock: conv1-BN-ReLU, conv2-BN-ReLU (the
    pre-add ReLU), + bypass (1x1 conv-BN or identity), ReLU. A ``dual``
    input is joined by an explicit concat [x, dual]."""

    def __init__(self, sd: StateDict, pref: str, *, stride: int = 1,
                 policy: Policy = Policy(), device=None, qat: bool = False,
                 qpack: int = 1, zone: bool = True):
        super().__init__()
        kw = dict(policy=policy, device=device)
        ckw = dict(kw, qat=qat, qpack=qpack, zone=zone)
        self.conv1 = Conv(sd, f"{pref}.conv1", stride=stride, **ckw)
        self.bn1 = BatchNorm(sd, f"{pref}.bn1", **kw)
        self.conv2 = Conv(sd, f"{pref}.conv2", **ckw)
        self.bn2 = BatchNorm(sd, f"{pref}.bn2", **kw)
        self.bypass = self.bnpass = None
        if f"{pref}.bypass.weight" in sd:
            self.bypass = Conv(sd, f"{pref}.bypass", stride=stride, **ckw)
            self.bnpass = BatchNorm(sd, f"{pref}.bnpass", **kw)

    def forward(self, x: torch.Tensor,
                dual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if dual is not None:
            x = torch.cat([x, dual.to(x.dtype)], dim=-1)
        y = conv_bn(self.conv1, self.bn1, x, act=True)
        r = (x if self.bypass is None
             else conv_bn(self.bypass, self.bnpass, x, act=False))
        y = conv_bn(self.conv2, self.bn2, y, act=True)
        return torch.relu(y + r)


class TrainDoubleResNet(nn.Module):
    """Two stacked train-mode BasicBlocks (res1 carries the stride and
    the dual input)."""

    def __init__(self, sd: StateDict, pref: str, *, stride: int = 1,
                 policy: Policy = Policy(), device=None, qat: bool = False,
                 qpack: int = 1, zone: bool = True):
        super().__init__()
        kw = dict(policy=policy, device=device, qat=qat, qpack=qpack,
                  zone=zone)
        self.res1 = TrainBasicBlock(sd, f"{pref}.res1", stride=stride, **kw)
        self.res2 = TrainBasicBlock(sd, f"{pref}.res2", **kw)

    def forward(self, x, dual=None):
        return self.res2(self.res1(x, dual))


class TrainDeconv2x(nn.Module):
    """Train-mode ConvTranspose2d(k=4, s=2, p=1, no bias): ``weight``
    (ci, co, 4, 4) f32. Where JAX runs pallas_deconv2x_ad
    (``_fused_form``: policy.fused_train_deconv, in the packed zone,
    ``zone``, deconv_ad_fuses at its input's lane geometry) an exact 2x
    target runs deconv2x_ad (K3, K10, dW rounded to the compute dtype
    as in JAX), whose wrappers raise on the card at a shape none was
    compiled for; otherwise F.conv_transpose2d under autograd (XLA in
    JAX). Under QAT the input and the kernel are fake-quantized first,
    as JAX's packed Deconv2x does before it routes."""

    def __init__(self, sd: StateDict, key: str, *, policy: Policy = Policy(),
                 device=None, qat: bool = False, qpack: int = 1,
                 zone: bool = True):
        super().__init__()
        device = resolve_device(device)
        self.weight = nn.Parameter(sd[f"{key}.weight"].float().to(device)
                                   .clone())
        self.shape = tuple(self.weight.shape[:2])  # (ci, co)
        self.cdt = policy.compute_dtype
        self.qat = qat and policy.quant_train
        self.qpack, self.pct = qpack, policy.quant_percentile
        self.fuse_ok = policy.fused_train_deconv and zone
        self.ad = self._fused_form(None)  # at the zone's widths
        self.model_shard = None  # as Conv's (dim 1: output channels)

    def _fused_form(self, width: Optional[int]) -> bool:
        """Whether JAX runs this upsample on pallas_deconv2x_ad at this
        input width (at an exact 2x target)."""
        return self.fuse_ok and deconv_ad_fuses(*self.shape, width,
                                                self.qpack)

    def forward(self, x: torch.Tensor,
                target_hw: Tuple[int, int]) -> torch.Tensor:
        w, shard = self.weight, self.model_shard
        if self.qat:
            x = quant_ops.fake_quant_act(x, self.pct, self.qpack)
            w = quant_ops.fake_quant_weight(_whole(w, shard).permute(
                2, 3, 0, 1)).permute(2, 3, 0, 1)
            shard = None
        if (tuple(target_hw) == (2 * x.shape[1], 2 * x.shape[2])
                and self._fused_form(x.shape[2])):
            # cast and laid out (4, 4, ci, co) in one copy
            return deconv_ops.deconv2x_ad(x, _whole(w, shard).permute(
                2, 3, 0, 1).to(self.cdt,
                               memory_format=torch.contiguous_format))
        if shard is not None:  # this rank's output channels, gathered
            return shard.gather(deconv_to(shard.enter(x), w.to(self.cdt),
                                          target_hw), dim=-1)
        return deconv_to(x, w.to(self.cdt), target_hw)


class TrainDecoderBlock(nn.Module):
    """Train-mode decoder stage: deconv 2x → [up, skip] → DoubleResNet."""

    def __init__(self, sd: StateDict, pref: str, *, policy: Policy = Policy(),
                 device=None, qat: bool = False, qpack: int = 1,
                 zone: bool = True):
        super().__init__()
        kw = dict(policy=policy, device=device, qat=qat, qpack=qpack,
                  zone=zone)
        self.deconv = TrainDeconv2x(sd, f"{pref}.deconv", **kw)
        self.res = TrainDoubleResNet(sd, f"{pref}.res", **kw)

    def forward(self, x, skip):
        up = self.deconv(x, (skip.shape[1], skip.shape[2]))
        return self.res(up, dual=skip)


class TrainASPP(nn.Module):
    """Train-mode ASPP: ``B{b}_conv`` / ``B{b}_bn`` under ``pref`` as the
    reference names them, each branch a train-mode ConvBN (a dilated
    conv never in the zone), then the max-pool branch and the concat."""

    def __init__(self, sd: StateDict, pref: str, *, policy: Policy = Policy(),
                 device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        for b, d in ASPP_BRANCHES:
            self.add_module(f"{b}_conv", Conv(sd, f"{pref}.{b}_conv",
                                              dilation=d, zone=False, **kw))
            self.add_module(f"{b}_bn", BatchNorm(sd, f"{pref}.{b}_bn", **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = [conv_bn(getattr(self, f"{b}_conv"), getattr(self, f"{b}_bn"),
                        x, act=True) for b, _ in ASPP_BRANCHES]
        return torch.cat(outs + [aspp_pool(x).to(outs[0].dtype)], dim=-1)


class TrainASPPCombine(nn.Module):
    """Train-mode ASPP recompression: ``ASPP_conv`` → ``ASPP_bn`` →
    ReLU."""

    def __init__(self, sd: StateDict, pref: str, *, policy: Policy = Policy(),
                 device=None):
        super().__init__()
        kw = dict(policy=policy, device=device)
        self.ASPP_conv = Conv(sd, f"{pref}.ASPP_conv", zone=False, **kw)
        self.ASPP_bn = BatchNorm(sd, f"{pref}.ASPP_bn", **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(self.ASPP_conv, self.ASPP_bn, x, act=True)
