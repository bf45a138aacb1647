"""Plain float32 ASPP-ResNet: the yardstick that decides whether the
port's outputs are correct for a configuration whose ``arch`` is
``aspp_resnet``.

Written from the architecture's description (the reference's
models/ASPP_ResNet.py: ``ASPP_ResNet`` at ln 291, ``ASPP`` at ln
188-263, ``ASPP_post`` at ln 266-286, the widened skips at ln 451-485,
the decoder's channel plan at ln 361-375), NCHW, with
torch.nn.functional ops only. It imports nothing of the port and reads a
reference-format state_dict (UResNet's key names plus
``ASPP_layer_enc{i}.B{b}_conv`` / ``_bn`` and
``ASPP_combine_enc{i}.ASPP_conv`` / ``ASPP_bn``), which the benchmark
generates itself. It keeps the contract written at the head of
reference/uresnet.py, whose stem, BasicBlock, DoubleResNet, upsample and
head it shares (p = inplanes):

  stem, encoder: as UResNet's, e1..e5 at p, 2p, 4p, 8p, 16p channels
  ASPP at e3, e4, e5: four biased conv-BN-ReLU branches of
           ``aspp_branch_features`` outputs each — 1x1, 3x3, 3x3 at
           dilation 3, 3x3 at dilation 5 — and the 3x3 stride-1 max pool
           of e, concatenated in that order (B1, B2, B3, B4, pool)
  combine: a biased 1x1 conv-BN-ReLU back to e's width
  skip:    cat [combine(aspp(e)), e]: 16p, 32p, 64p channels at e3-e5
  decoder: dec5 deconv 64p -> 16p, cat e4's skip, res 48p -> 32p;
           dec4 deconv 32p -> 8p, cat e3's skip, res 24p -> 16p;
           dec3 deconv 16p -> 4p, cat e2, res 8p -> 4p; dec2, dec1 as
           UResNet's
  head:    as UResNet's

Departures from the published code:

* BatchNorm in training moves the running variance towards the batch's
  biased variance (flax's semantics, which the program states;
  reference/shared.py), where torch's BatchNorm2d takes the unbiased.
* The published ``conv11`` takes ``inplanes`` input channels (ln 386)
  where the head gives it ``final_conv_kernels``; the two are equal (16)
  at the trainers' width, the only one at which the published network
  runs, and this reference takes the head's.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import shared, uresnet
from portbench.reference.shared import StateDict

Shape = Tuple[int, ...]
is_param = shared.is_param

DEPTH = 5
ASPP_STAGES = (3, 4, 5)
# ASPP's four conv branches: name, kernel, dilation
BRANCHES = (("B1", 1, 1), ("B2", 3, 1), ("B3", 3, 3), ("B4", 3, 5))


def layout(cfg: dict) -> Tuple[List[Tuple[str, Shape, int]],
                               List[Tuple[str, int]], List[Tuple[str, int]]]:
    """(conv weights [(key, shape, fan_out)], conv biases [(key,
    fan_in)], BNs [(key, channels)]) of the ASPP-ResNet ``cfg``
    describes."""
    if cfg["depth"] != DEPTH:
        raise ValueError(f"ASPP-ResNet has depth {DEPTH}, not {cfg['depth']}")
    p, bf = cfg["inplanes"], cfg["aspp_branch_features"]
    convs: List[Tuple[str, Shape, int]] = []
    biases: List[Tuple[str, int]] = []
    bns: List[Tuple[str, int]] = []

    def conv(key, co, ci, k, bn=None, bias=False):
        convs.append((f"{key}.weight", (co, ci, k, k), k * k * co))
        if bias:
            biases.append((f"{key}.bias", ci * k * k))
        if bn:
            bns.append((bn, co))

    def block(pref, ci, co, stride):
        conv(f"{pref}.conv1", co, ci, 3, f"{pref}.bn1")
        conv(f"{pref}.conv2", co, co, 3, f"{pref}.bn2")
        if ci != co or stride > 1:
            conv(f"{pref}.bypass", co, ci, 1, f"{pref}.bnpass")

    chans = [p * 2 ** i for i in range(DEPTH + 1)]
    conv("conv1", p, cfg["input_channels"], 7, "bn1", bias=True)
    for i in range(1, DEPTH + 1):
        block(f"enc_layer{i}.res1", chans[i - 1], chans[i], 1 if i == 1 else 2)
        block(f"enc_layer{i}.res2", chans[i], chans[i], 1)
    for i in ASPP_STAGES:
        c = chans[i]
        for b, k, _ in BRANCHES:
            conv(f"ASPP_layer_enc{i}.{b}_conv", bf, c, k,
                 f"ASPP_layer_enc{i}.{b}_bn", bias=True)
        conv(f"ASPP_combine_enc{i}.ASPP_conv", c, 4 * bf + c, 1,
             f"ASPP_combine_enc{i}.ASPP_bn", bias=True)
    # decoder stage i: deconv ci -> cu, then res over cu + skip -> co
    plan = {i: (chans[i], chans[i - 1], 2 * chans[i - 1], chans[i - 1])
            for i in range(1, DEPTH + 1)}
    plan.update({5: (64 * p, 16 * p, 48 * p, 32 * p),
                 4: (32 * p, 8 * p, 24 * p, 16 * p),
                 3: (16 * p, 4 * p, 8 * p, 4 * p)})
    for i in range(DEPTH, 0, -1):
        ci, cu, cres, co = plan[i]
        convs.append((f"dec_layer{i}.deconv.weight", (ci, cu, 4, 4), 16 * cu))
        block(f"dec_layer{i}.res.res1", cres, co, 1)
        block(f"dec_layer{i}.res.res2", co, co, 1)
    fk = cfg["final_conv_kernels"]
    conv("conv10", fk, p, 7, "bn10", bias=True)
    conv("conv11", cfg["num_classes"], fk, 7, bias=True)
    return convs, biases, bns


class Net(uresnet.Net):
    """ASPP-ResNet over a state_dict ``sd``; the other arguments as
    shared.Layers's."""

    def conv_bn_relu(self, x, key, bn, dilation=1):
        """A biased conv at ``dilation`` (its padding keeps the size),
        then BN and ReLU."""
        w = self.sd[f"{key}.weight"]
        y = F.conv2d(self._q(x), self._q(w), self.sd[f"{key}.bias"],
                     padding=dilation * (w.shape[-1] // 2),
                     dilation=dilation)
        return torch.relu(self.bn(y, bn))

    def widen(self, e, i):
        """The skip of encoder stage ``i``: [combine(aspp(e)), e]."""
        pref = f"ASPP_layer_enc{i}"
        outs = [self.conv_bn_relu(e, f"{pref}.{b}_conv", f"{pref}.{b}_bn", d)
                for b, _, d in BRANCHES]
        outs.append(F.max_pool2d(e, 3, 1, 1))
        post = f"ASPP_combine_enc{i}"
        a = self.conv_bn_relu(torch.cat(outs, 1), f"{post}.ASPP_conv",
                              f"{post}.ASPP_bn")
        return torch.cat([a, e], 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(b, c, h, w) float32 -> (b, classes, h, w) logits."""
        x0 = torch.relu(self.bn(self.conv(x, "conv1"), "bn1"))
        y = F.max_pool2d(x0, 3, 2, 1)
        skips = [x0]
        for i in range(1, DEPTH + 1):
            y = self.double(y, f"enc_layer{i}", 1 if i == 1 else 2)
            skips.append(self.widen(y, i) if i in ASPP_STAGES else y)
        y = skips[DEPTH]
        for i in range(DEPTH, 0, -1):
            skip = skips[i - 1]
            up = self.deconv(y, f"dec_layer{i}.deconv", skip)
            y = self.double(torch.cat([up, skip], 1), f"dec_layer{i}.res")
        y = torch.relu(self.bn(self.conv(y, "conv10"), "bn10"))
        return self.conv(y, "conv11")


def probabilities(sd: StateDict, crops: torch.Tensor, chunk: int = 4
                  ) -> torch.Tensor:
    return shared.probabilities(Net, sd, crops, chunk)


def train_steps(sd: StateDict, batches, lr: float, weight_decay: float,
                quant: bool = False) -> dict:
    return shared.train_steps(Net, sd, batches, lr, weight_decay, quant)
