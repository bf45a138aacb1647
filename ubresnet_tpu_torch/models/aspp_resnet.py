"""ASPP-ResNet, NHWC (counterpart of ubresnet_tpu/models/aspp_resnet.py):
``ASPPResNet`` in eval mode and ``TrainASPPResNet``, its trainable form.

The U-ResNet skeleton (stem, five encoder stages, five decoder stages,
head) with atrous spatial pyramid pooling on the skips of encoder
stages 3, 4 and 5: each feature e goes through ASPP (four conv-BN-ReLU
branches, 1x1 and 3x3 at dilations 1, 3 and 5, and a 3x3 stride-1 max
pool) and a 1x1 recompression back to e's width, and the skip is the
concat [combine(aspp(e)), e]. The decoder is widened to match
(ASPP_ResNet.py:361-375):

  dec5: deconv 64p → 16p, cat e4 skip (32p), res → 32p
  dec4: deconv 32p → 8p,  cat e3 skip (16p), res → 16p
  dec3: deconv 16p → 4p,  cat e2 (4p),       res → 4p
  dec2, dec1: as in UResNet

Built from a reference-format ASPP_ResNet state_dict (UResNet's key
names plus ``ASPP_layer_enc{i}`` and ``ASPP_combine_enc{i}``), which
fixes its geometry. At the flagship width (inplanes 16) the kernel zone
has UResNet's shapes exactly — stem pool, enc1, dec2, dec1, head,
classifier — so the default policy runs the same 11 launches per
forward, ``Policy.int8()`` the same int8 zone and the train step the
same train zone; ASPP's branches, the recompressions and the widened
deep decoder are torch.nn.functional ops (cuDNN), as XLA convs in JAX.

One difference from UResNet that shows in numbers: JAX's ASPP packs
every zone stage at ``pack_width`` 8 (UResNet at min(8, 128 // c)),
so the W-packing factor that calibration's strided subsample and the
QAT percentile read is 8 throughout, and the packed (int8, QAT) zone
exists for every input width that is a multiple of 16 (and runs for
multiples of 32: ``packed_zone``).

Each widened skip (ASPP, its recompression and the concat) runs in a
``model.aspp`` span (utils/profiling.py:span) whose id is its encoder
stage, 3, 4 or 5: ``ubresnet.model.aspp`` in a torch profile.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.models.blocks import (
    ASPP,
    ASPPCombine,
    BatchNorm,
    Conv,
    ConvBN,
    DecoderBlock,
    DoubleResNet,
    TrainASPP,
    TrainASPPCombine,
    TrainDecoderBlock,
    TrainDoubleResNet,
    conv_bn,
    stem_pool,
    zone_active,
)
from ubresnet_tpu_torch.models.uresnet import (
    PACK_MAX,
    ROW_HALO,
    ZoneModel,
    plain_call,
    stage_call,
)
from ubresnet_tpu_torch.parallel.sharding import halo_apply
from ubresnet_tpu_torch.utils.platform import resolve_device
from ubresnet_tpu_torch.utils.profiling import span

DEPTH = 5
ASPP_STAGES = (3, 4, 5)  # the encoder stages whose skips ASPP widens
ZONE_STEP = 2 * PACK_MAX  # JAX packs when the width is a multiple of 16
# ... and then packs dec2's input, at a quarter of the width, at 8 too:
# a packed width that is no multiple of 32 raises there
PACKED_STEP = 4 * PACK_MAX


@dataclasses.dataclass(frozen=True)
class ASPPResNetConfig:
    num_classes: int = 3
    input_channels: int = 1
    inplanes: int = 16
    final_conv_kernels: int = 16
    aspp_branch_features: int = 16


def config_from_state_dict(sd: Dict[str, torch.Tensor]) -> ASPPResNetConfig:
    """Geometry read off the weights."""
    w = sd["conv1.weight"]
    return ASPPResNetConfig(
        num_classes=int(sd["conv11.weight"].shape[0]),
        input_channels=int(w.shape[1]),
        inplanes=int(w.shape[0]),
        final_conv_kernels=int(sd["conv10.weight"].shape[0]),
        aspp_branch_features=int(
            sd["ASPP_layer_enc3.B1_conv.weight"].shape[0]),
    )


def packed_zone(width: int) -> bool:
    """Whether the JAX package runs its packed (and int8, QAT) zone for
    inputs of this width (aspp_resnet.py:65-66): a multiple of 16. It
    then also packs dec2's input (width / 4) at 8 and raises unless the
    width is a multiple of 32; so does this."""
    if width % ZONE_STEP:
        return False
    if width % PACKED_STEP:
        raise ValueError(
            f"input width {width}: the JAX package's ASPP packs it and "
            f"then dec2's input, width {width // 4}, at {PACK_MAX}, which "
            f"needs a multiple of {PACKED_STEP}")
    return True


def check_zone(policy: Policy, width: int) -> None:
    """Raise where the JAX package would run without its packed zone,
    and so silently without the int8 or QAT zone the policy asks for (an
    input width that is no multiple of 16), or where it cannot run it
    (``packed_zone``)."""
    what = ("int8" if policy.quant_eval else "QAT" if policy.quant_train
            else None)
    if what is not None and not packed_zone(width):
        raise ValueError(
            f"{what}: input width {width} is not a multiple of {ZONE_STEP}; "
            f"the JAX package runs such inputs unpacked, without its "
            f"{what} zone")


def _widen(e: torch.Tensor, aspp, combine, stage=plain_call
           ) -> torch.Tensor:
    """The widened skip [combine(aspp(e)), e] (aspp_resnet.py:109-117),
    each module called through ``stage``."""
    a = stage(combine, stage(aspp, e))
    return torch.cat([a, e.to(a.dtype)], dim=-1)


def _widened(encs, aspps, combines, stage=plain_call):
    """The widened skips of ``ASPP_STAGES`` from the encoder outputs
    ``encs``, each in a ``model.aspp`` span whose id is its encoder
    stage."""
    out = []
    for i, aspp, combine in zip(ASPP_STAGES, aspps, combines):
        with span("model.aspp", i):
            out.append(_widen(encs[i - 1], aspp, combine, stage))
    return out


class ASPPResNet(ZoneModel):
    """Input (b, h, w, c) NHWC; output (b, h, w, num_classes)
    log-probabilities (or logits) in ``policy.output_dtype``.

    ``policy.quant_eval`` runs the int8 zone — stem, enc1, dec2, dec1,
    head, as in UResNet (per forward K1-s8 x1, K2-s8 x6, K3-s8 x2
    beside the bf16 K4 pool and K1 classifier) — once
    ``set_quant_scales`` has the scales of ``ops.quant.calibrate``;
    ``policy.quant_train`` fake-quantizes that zone and the classifier's
    kernel. Either needs input widths that are a multiple of 32."""

    def __init__(self, state_dict: Dict[str, torch.Tensor],
                 policy: Policy = Policy(), device=None):
        super().__init__()
        sd = {k: v.detach().cpu() for k, v in state_dict.items()}
        self.config = config_from_state_dict(sd)
        self.policy = policy
        self.device = resolve_device(device)
        self._sd = sd  # the source weights, for calibration_model()
        q = policy.quant_eval
        kw = dict(policy=policy, device=self.device)
        self.conv1 = ConvBN(sd, "conv1", "bn1", quant=q, qpack=PACK_MAX,
                            qat=True, **kw)
        self.enc = nn.ModuleList(
            DoubleResNet(sd, f"enc_layer{i}", stride=1 if i == 1 else 2,
                         quant=q and i == 1, qat=i == 1, zone=i == 1,
                         qpack=PACK_MAX if i == 1 else 1, **kw)
            for i in range(1, DEPTH + 1))
        self.aspp = nn.ModuleList(ASPP(sd, f"ASPP_layer_enc{i}", **kw)
                                  for i in ASPP_STAGES)
        self.combine = nn.ModuleList(
            ASPPCombine(sd, f"ASPP_combine_enc{i}", **kw)
            for i in ASPP_STAGES)
        # dec[0] is dec_layer5, the deepest, which runs first
        self.dec = nn.ModuleList(
            DecoderBlock(sd, f"dec_layer{i}", quant=q and i <= 2, qat=i <= 2,
                         zone=i <= 2, qpack=PACK_MAX if i <= 2 else 1, **kw)
            for i in range(DEPTH, 0, -1))
        self.conv10 = ConvBN(sd, "conv10", "bn10", quant=q, qpack=PACK_MAX,
                             qat=True, **kw)
        self.conv11 = ConvBN(sd, "conv11", None, act=False, qat=True,
                             qpack=PACK_MAX, **kw)

    def packed_zone(self, width: int) -> bool:
        return packed_zone(width)

    def zone_runs(self, width: int) -> bool:
        return width % ZONE_STEP == 0

    def _check_width(self, width: int) -> None:
        check_zone(self.policy, width)

    def _stem_pack(self) -> int:
        return PACK_MAX

    def _skip_rows(self, stage, y, at):
        """ASPP's widened skip of encoder stages 3-5, its dilation-5
        branch reading ROW_HALO["aspp"] rows beyond the slab."""
        if stage not in ASPP_STAGES:
            return y
        k = ASPP_STAGES.index(stage)
        with span("model.aspp", stage):
            return halo_apply(lambda d, e: _widen(e, at(d).aspp[k],
                                                  at(d).combine[k]),
                              y, ROW_HALO["aspp"])

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        pol = self.policy
        check_zone(pol, x.shape[2])
        with zone_active(self.zone_runs(x.shape[2])):
            x0 = self.conv1(x.to(pol.compute_dtype).contiguous())
            y = stem_pool(x0, fused=pol.fused_eval, pack=PACK_MAX)
            encs = []
            for enc in self.enc:
                y = enc(y)
                encs.append(y)
            e3, e4, e5 = _widened(encs, self.aspp, self.combine)
            dec5, dec4, dec3, dec2, dec1 = self.dec
            y = dec5(e5, e4)
            y = dec4(y, e3)
            y = dec3(y, encs[1])
            y = dec2(y, encs[0])
            y = dec1(y, x0)
            y = self.conv11(self.conv10(y)).to(pol.output_dtype)
        if logits:
            return y
        return torch.log_softmax(y, dim=-1)


class TrainASPPResNet(nn.Module):
    """The trainable ASPP-ResNet: ``ASPPResNet``'s network with f32
    parameters and BN running stats under the reference key names, so
    ``state_dict()`` is a reference ASPP_ResNet state_dict. With
    ``policy.fused_train`` the train zone runs on the Hopper kernels as
    in ``TrainUResNet`` (per step K5 x16, K1 x18, K6 x17, K4 x1; the
    dilated branches never); ``policy.quant_train`` fake-quantizes the
    packed zone at pack 8 and needs input widths that are a multiple of
    32 (``packed_zone``); ``policy.remat`` (train mode) recomputes each
    encoder, ASPP, recompression and decoder stage in backward, the BN
    running stats still moving once a step. Input (b, h, w, c) NHWC;
    output (b, h, w, num_classes) logits (or log-probabilities) in
    ``policy.output_dtype``."""

    def __init__(self, state_dict: Dict[str, torch.Tensor],
                 policy: Policy = Policy(), device=None):
        super().__init__()
        sd = {k: v.detach().cpu() for k, v in state_dict.items()}
        self.config = config_from_state_dict(sd)
        self.policy = policy
        kw = dict(policy=policy, device=resolve_device(device))
        self.conv1 = Conv(sd, "conv1", qat=True, qpack=PACK_MAX, **kw)
        self.bn1 = BatchNorm(sd, "bn1", **kw)
        for i in range(1, DEPTH + 1):
            self.add_module(f"enc_layer{i}", TrainDoubleResNet(
                sd, f"enc_layer{i}", stride=1 if i == 1 else 2, qat=i == 1,
                zone=i == 1, qpack=PACK_MAX if i == 1 else 1, **kw))
        for i in ASPP_STAGES:
            self.add_module(f"ASPP_layer_enc{i}",
                            TrainASPP(sd, f"ASPP_layer_enc{i}", **kw))
            self.add_module(f"ASPP_combine_enc{i}",
                            TrainASPPCombine(sd, f"ASPP_combine_enc{i}", **kw))
        for i in range(DEPTH, 0, -1):
            self.add_module(f"dec_layer{i}", TrainDecoderBlock(
                sd, f"dec_layer{i}", qat=i <= 2, zone=i <= 2,
                qpack=PACK_MAX if i <= 2 else 1, **kw))
        self.conv10 = Conv(sd, "conv10", qat=True, qpack=PACK_MAX, **kw)
        self.bn10 = BatchNorm(sd, "bn10", **kw)
        self.conv11 = Conv(sd, "conv11", bn=False, qat=True, qpack=PACK_MAX,
                           **kw)

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        check_zone(self.policy, x.shape[2])
        with zone_active(x.shape[2] % ZONE_STEP == 0):
            y = self._forward(x)
        if logits:
            return y
        return torch.log_softmax(y, dim=-1)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The logits in ``policy.output_dtype``."""
        pol = self.policy
        x0 = conv_bn(self.conv1, self.bn1,
                     x.to(pol.compute_dtype).contiguous(), act=True)
        y = stem_pool(x0, fused=pol.fused_train, pack=PACK_MAX, train=True)
        # Policy.remat: each stage, ASPP and recompression recomputed in
        # backward (JAX's stage_call, aspp_resnet.py:83-117)
        stage = stage_call(pol, self.training)
        encs = []
        for i in range(1, DEPTH + 1):
            y = stage(getattr(self, f"enc_layer{i}"), y)
            encs.append(y)
        e3, e4, e5 = _widened(
            encs, [getattr(self, f"ASPP_layer_enc{i}") for i in ASPP_STAGES],
            [getattr(self, f"ASPP_combine_enc{i}") for i in ASPP_STAGES],
            stage)
        y = stage(self.dec_layer5, e5, e4)
        y = stage(self.dec_layer4, y, e3)
        y = stage(self.dec_layer3, y, encs[1])
        y = stage(self.dec_layer2, y, encs[0])
        y = stage(self.dec_layer1, y, x0)
        y = conv_bn(self.conv10, self.bn10, y, act=True)
        return self.conv11(y).to(pol.output_dtype)
