"""U-ResNet, the flagship MicroBooNE SSNet model, NHWC (counterpart of
ubresnet_tpu/models/uresnet.py): ``UResNet`` in eval mode and
``TrainUResNet``, its trainable form.

  stem:    7x7 conv(bias) → BN → ReLU → 3x3 maxpool s2
  encoder: ``depth`` × DoubleResNet, channels ×2 per stage, strides
           1, 2, 2, ...
  decoder: ``depth`` × (deconv k4 s2 → [up, skip] → DoubleResNet)
  head:    7x7 conv → BN → ReLU → 7x7 conv → log-softmax over classes

Built from a reference-format state_dict (``enc_layer{i}``,
``dec_layer{i}``, ``conv10``, ``conv11`` ... names), which also fixes
its geometry. With the default policy the layers the JAX package runs
in Pallas run on the Hopper kernels of ops/ (models/blocks.py routes):
the stem pool, enc1, dec2, dec1, the head and the classifier at the
flagship width (11 launches per forward), the same but dec2's upsample
and the head at inplanes 32 (9); the rest are torch.nn.functional
ops. Under ``Policy.int8()`` nine of those eleven
launches are the int8 kernels (``UResNet`` docstring). Under
``Policy.quant_train`` (QAT) both models fake-quantize the JAX
package's packed zone (``zone_packs``). It is built on the card unless
``device="cpu"`` is passed; with no card and no explicit cpu it
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.models.blocks import (
    BatchNorm,
    Conv,
    ConvBN,
    DecoderBlock,
    DoubleResNet,
    TrainDecoderBlock,
    TrainDoubleResNet,
    conv_bn,
    remat,
    stem_pool,
    zone_active,
)
from ubresnet_tpu_torch.parallel.sharding import RowSlabs, halo_apply
from ubresnet_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class UResNetConfig:
    num_classes: int = 3
    input_channels: int = 1
    inplanes: int = 16
    final_conv_kernels: int = 16
    depth: int = 5


def config_from_state_dict(sd: Dict[str, torch.Tensor]) -> UResNetConfig:
    """Geometry read off the weights (as deploy/importers.py infers it)."""
    w = sd["conv1.weight"]
    depth = 0
    while f"enc_layer{depth + 1}.res1.conv1.weight" in sd:
        depth += 1
    return UResNetConfig(
        num_classes=int(sd["conv11.weight"].shape[0]),
        input_channels=int(w.shape[1]),
        inplanes=int(w.shape[0]),
        final_conv_kernels=int(sd["conv10.weight"].shape[0]),
        depth=depth,
    )


PACK_MAX = 8  # the JAX package's pack_width (Policy.tpu / tpu_int8)

# Rows of its input that a stage reads beyond the ones it owns on a row
# slab (ZoneModel.forward_rows): its receptive radius, the sum of its
# convs' (k // 2)·dilation at the input's resolution, rounded up to even
ROW_HALO = {
    "stem": 4,      # the 7x7 stem conv (3)
    "pool": 2,      # the 3x3 s2 stem pool (1)
    "stage": 4,     # a stride-1 DoubleResNet: four 3x3 convs (4)
    "stage_s2": 8,  # a stride-2 one: 1 + 2·3 rows of its input (7)
    "deconv": 2,    # the k4 s2 deconv (1 input row)
    "head": 6,      # conv10 and conv11, two 7x7 convs (6)
    "aspp": 6,      # ASPP's 3x3 branch at dilation 5 (5)
}


def check_zone(cfg: UResNetConfig, policy: Policy, width: int = None
               ) -> None:
    """Raise where the JAX package would run without its packed zone
    (uresnet.py:68-70), and so silently without the int8 or QAT zone
    the policy asks for: depth other than 5, or (given) an input width
    that is no multiple of 2·p_stem."""
    what = ("int8" if policy.quant_eval else "QAT" if policy.quant_train
            else None)
    if what is None:
        return
    if cfg.depth != 5:
        raise ValueError(f"{what}: the JAX package quantizes its packed "
                         f"zone, which exists at depth 5 (got {cfg.depth})")
    step = 2 * zone_packs(cfg)["stem"]
    if width is not None and width % step:
        raise ValueError(
            f"{what}: input width {width} is not a multiple of {step}; "
            f"the JAX package runs such inputs unpacked, without its "
            f"{what} zone")


def packed_zone(cfg: UResNetConfig, width: int) -> bool:
    """Whether the JAX package runs its packed (and int8, QAT) zone for
    inputs of this width (uresnet.py:68-70): depth 5 and a width that is
    a multiple of 2·p_stem. Outside it JAX calls no Pallas kernel, and
    the port's layers take their plain routes (models/blocks.py
    ``zone_active``)."""
    return cfg.depth == 5 and width % (2 * zone_packs(cfg)["stem"]) == 0


def zone_packs(cfg: UResNetConfig) -> Dict[str, int]:
    """W-packing factor of each packed-zone stage in the JAX package
    (uresnet.py:63-67,111,123,134): min(8, 128 // channels). The int8
    zone is this zone; its factors shape calibration's strided subsample
    (ops/quant.py:packed_view)."""
    def p_for(c):
        return max(1, min(PACK_MAX, 128 // c))

    return {"stem": p_for(cfg.inplanes), "enc1": p_for(2 * cfg.inplanes),
            "dec2": p_for(2 * cfg.inplanes), "dec1": p_for(cfg.inplanes),
            "head": p_for(cfg.final_conv_kernels)}


class ZoneModel(nn.Module):
    """What the runners, calibration and the trainer call on an eval
    model beyond ``forward(x, logits=False)``, ``config``, ``policy``
    and ``device``: ``packed_zone(width)`` (the subclass's),
    ``calibration_model()``, ``replica(device)``, ``observe(fn)`` and
    ``set_quant_scales(scales)``. The subclass keeps its source weights
    in ``_sd``."""

    def packed_zone(self, width: int) -> bool:
        raise NotImplementedError

    def calibration_model(self) -> "ZoneModel":
        """The same weights unfused and unquantized on the same device:
        the forward ``ops.quant.calibrate`` observes, as JAX calibrates
        (ops/quant.py:154-167)."""
        pol = dataclasses.replace(self.policy, fused_eval=False,
                                  quant_eval=False)
        return type(self)(self._sd, policy=pol, device=self.device)

    def replica(self, device) -> "ZoneModel":
        """The same weights and policy on ``device`` (no scales: give it
        ``set_quant_scales``'s)."""
        return type(self)(self._sd, policy=self.policy, device=device)

    def observe(self, fn) -> None:
        """Route every layer's input to ``fn(name, x, pack)`` (None
        stops it)."""
        for m in self.modules():
            if hasattr(m, "observer"):
                m.observer = fn

    def set_quant_scales(self, scales: Dict[str, torch.Tensor]) -> None:
        """Quantize the int8 zone's weights and fold its gains from the
        calibrated activation scales ({JAX layer name: scalar})."""
        for m in self.modules():
            if getattr(m, "quant", False):
                m.set_scales(scales)

    # the row-sharded forward's hooks: the input checks and the zone of
    # ``forward`` at this width, the stem pool's pack, and the skip an
    # encoder stage hands the decoder (ASPP widens three)
    def _check_width(self, width: int) -> None:
        raise NotImplementedError

    def zone_runs(self, width: int) -> bool:
        return self.packed_zone(width)

    def _stem_pack(self) -> int:
        raise NotImplementedError

    def _skip_rows(self, stage: int, y: RowSlabs, at) -> RowSlabs:
        return y

    def forward_rows(self, slabs: RowSlabs, logits: bool = False,
                     replicas: Optional[Dict[torch.device, "ZoneModel"]]
                     = None) -> RowSlabs:
        """``forward`` of a plane split by rows over devices
        (parallel/sharding.py:row_split): each stage — the stem conv, the
        stem pool, every encoder stage, every decoder's upsample and its
        DoubleResNet over [up, skip], the head (conv10, conv11) — runs on
        every non-empty slab, on that slab's device (the model
        ``replicas`` holds for it, this one on its own device), with the
        rows of its neighbours that its halo needs (``ROW_HALO``), and
        keeps the rows the slab owns. The routes are the whole plane's:
        the gates read the plane's width, and every widened slab keeps
        an even height. So the output equals ``forward`` of the whole
        plane, and every stage launches its kernels once per non-empty
        slab. Returns the log-probabilities (or logits) as RowSlabs."""
        pol = self.policy
        width = slabs.width
        self._check_width(width)

        def at(dev):
            return self if dev == self.device else replicas[dev]

        with zone_active(self.zone_runs(width)):
            x0 = halo_apply(lambda d, x: at(d).conv1(
                x.to(pol.compute_dtype).contiguous()), slabs,
                ROW_HALO["stem"])
            y = halo_apply(lambda d, x: stem_pool(
                x, fused=pol.fused_eval, pack=self._stem_pack()), x0,
                ROW_HALO["pool"], "down")
            encs = []
            for i, enc in enumerate(self.enc):
                s2 = enc.res1.stride == 2
                y = halo_apply(lambda d, x, i=i: at(d).enc[i](x), y,
                               ROW_HALO["stage_s2" if s2 else "stage"],
                               "down" if s2 else "same")
                encs.append(self._skip_rows(i + 1, y, at))
            y = encs[-1]
            for j, skip in enumerate(reversed([x0] + encs[:-1])):
                up = halo_apply(lambda d, x, j=j: at(d).dec[j].deconv(
                    x, (2 * x.shape[1], 2 * x.shape[2])), y,
                    ROW_HALO["deconv"], "up")
                y = halo_apply(lambda d, u, s, j=j: at(d).dec[j].res(
                    u, dual=s), up, ROW_HALO["stage"], extras=[skip])
            y = halo_apply(lambda d, x: at(d).conv11(at(d).conv10(x)).to(
                pol.output_dtype), y, ROW_HALO["head"])
        if logits:
            return y
        return y.map(lambda t: torch.log_softmax(t, dim=-1))


class UResNet(ZoneModel):
    """Input (b, h, w, c) NHWC; output (b, h, w, num_classes)
    log-probabilities (or logits) in ``policy.output_dtype``.

    With ``policy.quant_eval`` the int8 zone — the stem conv, enc1,
    dec2, dec1 and the head conv10, the JAX package's packed zone, which
    exists at depth 5 — runs int8 (per forward K1-s8 x1, K2-s8 x6, K3-s8
    x2, beside the bf16 K4 pool and K1 classifier) once
    ``set_quant_scales`` has the scales of ``ops.quant.calibrate``; the
    input width must be a multiple of 2·p_stem (16), as JAX packs it.

    With ``policy.quant_train`` (QAT, the validation model of a QAT
    run) the same zone plus the classifier's kernel is fake-quantized
    per call; its blocks run per conv, so a forward launches K4 x1, K3
    x2 and K1 x2 (head, classifier) under fused_eval, no K2."""

    def __init__(self, state_dict: Dict[str, torch.Tensor],
                 policy: Policy = Policy(), device=None):
        super().__init__()
        sd = {k: v.detach().cpu() for k, v in state_dict.items()}
        self.config = cfg = config_from_state_dict(sd)
        self.policy = policy
        self.device = resolve_device(device)
        self._sd = sd  # the source weights, for calibration_model()
        check_zone(cfg, policy)
        q = policy.quant_eval
        packs = zone_packs(cfg)
        kw = dict(policy=policy, device=self.device)
        # the packed zone: int8 (quant) or QAT (qat) as the policy asks
        self.conv1 = ConvBN(sd, "conv1", "bn1", quant=q, qpack=packs["stem"],
                            qat=True, **kw)
        self.enc = nn.ModuleList(
            DoubleResNet(sd, f"enc_layer{i}", stride=1 if i == 1 else 2,
                         quant=q and i == 1, qat=i == 1, zone=i == 1,
                         qpack=packs["enc1"] if i == 1 else 1, **kw)
            for i in range(1, cfg.depth + 1))
        # dec[0] is dec_layer{depth}, the deepest, which runs first
        self.dec = nn.ModuleList(
            DecoderBlock(sd, f"dec_layer{i}", quant=q and i <= 2,
                         qat=i <= 2, zone=i <= 2,
                         qpack=packs.get(f"dec{i}", 1), **kw)
            for i in range(cfg.depth, 0, -1))
        self.conv10 = ConvBN(sd, "conv10", "bn10", quant=q,
                             qpack=packs["head"], qat=True, **kw)
        self.conv11 = ConvBN(sd, "conv11", None, act=False, qat=True,
                             qpack=packs["head"], **kw)

    def packed_zone(self, width: int) -> bool:
        """Whether the JAX package runs its packed (and int8) zone for
        inputs of this width (uresnet.py:68-70)."""
        return packed_zone(self.config, width)

    def _check_width(self, width: int) -> None:
        check_zone(self.config, self.policy, width)

    def _stem_pack(self) -> int:
        return zone_packs(self.config)["stem"]

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        pol = self.policy
        check_zone(self.config, pol, x.shape[2])
        with zone_active(self.packed_zone(x.shape[2])):
            x0 = self.conv1(x.to(pol.compute_dtype).contiguous())
            y = stem_pool(x0, fused=pol.fused_eval,
                          pack=zone_packs(self.config)["stem"])
            skips = [x0]
            for enc in self.enc:
                y = enc(y)
                skips.append(y)
            for dec, skip in zip(self.dec, reversed(skips[:-1])):
                y = dec(y, skip)
            y = self.conv11(self.conv10(y)).to(pol.output_dtype)
        if logits:
            return y
        return torch.log_softmax(y, dim=-1)


def plain_call(module: nn.Module, *args):
    return module(*args)


def stage_call(policy: Policy, training: bool):
    """How a train-mode model calls a stage: ``remat`` under
    ``policy.remat`` in train mode (JAX's nn.remat per stage), else a
    plain call."""
    return remat if policy.remat and training else plain_call


class TrainUResNet(nn.Module):
    """The trainable UResNet: the same network as ``UResNet`` with f32
    parameters and BN running stats as nn.Parameters and buffers under
    the reference key names, so ``state_dict()`` is a reference
    state_dict (deploy/weights.py:save_reference_checkpoint writes it,
    ``UResNet`` loads it). In train mode BN normalises by the batch
    moments and updates the running stats.

    With ``policy.fused_train`` the train zone — the stem pool, enc1,
    dec2, dec1, conv10 and conv11 at the flagship width — runs on the
    Hopper kernels forward and backward (per step: K5 x16, K1 x18, K6
    x17, K4 x1; at inplanes 32, without dec2's first conv and conv10,
    K5 x14, K1 x16, K6 x15, K4 x1); with ``policy.fused_train_deconv`` the dec2 and dec1
    upsamples too (K3 x2 forward, K10 x2 dx and dW); the rest are
    torch.nn.functional ops under autograd. With ``policy.quant_train``
    (QAT) the JAX package's packed zone — stem, enc1, dec2, dec1, head,
    the classifier's kernel — is fake-quantized; it needs depth 5 and
    input widths that are a multiple of 16, and raises otherwise. With
    ``policy.remat`` (train mode) each encoder and decoder stage is
    recomputed in backward (models/blocks.py:remat), and the BN running
    stats still move once a step. Input (b, h, w, c) NHWC; output (b, h,
    w, num_classes) logits (or log-probabilities) in
    ``policy.output_dtype``."""

    def __init__(self, state_dict: Dict[str, torch.Tensor],
                 policy: Policy = Policy(), device=None):
        super().__init__()
        sd = {k: v.detach().cpu() for k, v in state_dict.items()}
        self.config = cfg = config_from_state_dict(sd)
        self.policy = policy
        check_zone(cfg, policy)
        packs = zone_packs(cfg)
        kw = dict(policy=policy, device=resolve_device(device))
        self.conv1 = Conv(sd, "conv1", qat=True, qpack=packs["stem"], **kw)
        self.bn1 = BatchNorm(sd, "bn1", **kw)
        depth = cfg.depth
        for i in range(1, depth + 1):
            self.add_module(f"enc_layer{i}", TrainDoubleResNet(
                sd, f"enc_layer{i}", stride=1 if i == 1 else 2, qat=i == 1,
                zone=i == 1, qpack=packs["enc1"] if i == 1 else 1, **kw))
        for i in range(depth, 0, -1):
            self.add_module(f"dec_layer{i}", TrainDecoderBlock(
                sd, f"dec_layer{i}", qat=i <= 2, zone=i <= 2,
                qpack=packs.get(f"dec{i}", 1), **kw))
        self.conv10 = Conv(sd, "conv10", qat=True, qpack=packs["head"], **kw)
        self.bn10 = BatchNorm(sd, "bn10", **kw)
        self.conv11 = Conv(sd, "conv11", bn=False, qat=True,
                           qpack=packs["head"], **kw)

    def forward(self, x: torch.Tensor, logits: bool = False) -> torch.Tensor:
        check_zone(self.config, self.policy, x.shape[2])
        with zone_active(packed_zone(self.config, x.shape[2])):
            y = self._forward(x)
        if logits:
            return y
        return torch.log_softmax(y, dim=-1)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The logits in ``policy.output_dtype``."""
        pol = self.policy
        depth = self.config.depth
        x0 = conv_bn(self.conv1, self.bn1,
                     x.to(pol.compute_dtype).contiguous(), act=True)
        y = stem_pool(x0, fused=pol.fused_train,
                      pack=zone_packs(self.config)["stem"], train=True)
        # Policy.remat: each encoder and decoder stage is recomputed in
        # backward (JAX's nn.remat per stage, uresnet.py:92-104)
        stage = stage_call(pol, self.training)
        skips = [x0]
        for i in range(1, depth + 1):
            y = stage(getattr(self, f"enc_layer{i}"), y)
            skips.append(y)
        for i in range(depth, 0, -1):
            y = stage(getattr(self, f"dec_layer{i}"), y, skips[i - 1])
        y = conv_bn(self.conv10, self.bn10, y, act=True)
        return self.conv11(y).to(pol.output_dtype)
