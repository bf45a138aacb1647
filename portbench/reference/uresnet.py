"""Plain float32 UResNet: the yardstick that decides whether the port's
outputs are correct for a configuration whose ``arch`` is ``uresnet``.

Written from the architecture's description (the reference's
models/ub_uresnet.py:31-147 and models/common_layers.py:122-132), NCHW,
with torch.nn.functional ops only. It imports nothing of the port and
takes no weights, scales or tables the port made: it reads a
reference-format state_dict (``conv1.weight``, ``enc_layer1.res1.conv1``,
``dec_layer5.deconv`` ...), which the benchmark generates itself.

  stem:    7x7 conv (bias) -> BN -> ReLU -> 3x3 max pool, stride 2, pad 1
  encoder: ``depth`` DoubleResNets, channels x2 a stage, strides 1, 2, 2...
  decoder: ``depth`` x (4x4 stride-2 transposed conv -> concat [up, skip]
           -> DoubleResNet)
  head:    7x7 conv (bias) -> BN -> ReLU -> 7x7 conv (bias) -> logits

A BasicBlock is conv3x3-BN-ReLU, conv3x3-BN-ReLU (the pre-add ReLU),
plus the bypass (1x1 conv-BN where the channels or the stride change),
then ReLU.

Every ``reference/<arch>.py`` keeps this contract (a configuration's
``arch`` picks the module: lib/common.py:reference_module):

* ``layout(cfg)``: the configuration's (conv weights [(key, shape,
  fan_out)], conv biases [(key, fan_in)], BNs [(key, channels)]) under
  the reference's key names, in the order reference/weights.py draws
  them. Weight shapes: conv (out, in / groups, kh, kw), transposed conv
  (in, out / groups, kh, kw); ``fan_out`` is the k·k·out of the
  reference's init; a bias is as long as its weight's dim 0.
* ``Net(sd, train=False, quant=False, momentum=0.1)``: the network over
  a state_dict, called on (b, c, h, w) float32 for logits, its
  convolutions through F.conv2d and F.conv_transpose2d (work/arith.py
  counts them there); with ``train`` it moves the running statistics
  in ``sd``. shared.py's ``Layers`` gives conv, BN and the control.
* ``probabilities(sd, crops, chunk=4)``, ``train_steps(sd, batches, lr,
  weight_decay, quant=False)`` and ``is_param(key)``: shared.py's loops
  bound to ``Net``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import shared
from portbench.reference.shared import StateDict

Shape = Tuple[int, ...]
is_param = shared.is_param


def layout(cfg: dict) -> Tuple[List[Tuple[str, Shape, int]],
                               List[Tuple[str, int]], List[Tuple[str, int]]]:
    """(conv weights [(key, shape, fan_out)], conv biases [(key,
    fan_in)], BNs [(key, channels)]) of the UResNet ``cfg`` describes."""
    inplanes, depth = cfg["inplanes"], cfg["depth"]
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

    chans = [inplanes * 2 ** i for i in range(depth + 1)]
    conv("conv1", inplanes, cfg["input_channels"], 7, "bn1", bias=True)
    for i in range(1, depth + 1):
        block(f"enc_layer{i}.res1", chans[i - 1], chans[i], 1 if i == 1 else 2)
        block(f"enc_layer{i}.res2", chans[i], chans[i], 1)
    for i in range(depth, 0, -1):
        ci, cu = chans[i], chans[i - 1]
        convs.append((f"dec_layer{i}.deconv.weight", (ci, cu, 4, 4), 16 * cu))
        block(f"dec_layer{i}.res.res1", 2 * cu, cu, 1)
        block(f"dec_layer{i}.res.res2", cu, cu, 1)
    fk = cfg["final_conv_kernels"]
    conv("conv10", fk, inplanes, 7, "bn10", bias=True)
    conv("conv11", cfg["num_classes"], fk, 7, bias=True)
    return convs, biases, bns


def depth_of(sd: StateDict) -> int:
    depth = 0
    while f"enc_layer{depth + 1}.res1.conv1.weight" in sd:
        depth += 1
    return depth


class Net(shared.Layers):
    """UResNet over a state_dict ``sd``; the other arguments as
    shared.Layers's."""

    def __init__(self, sd: StateDict, train: bool = False,
                 quant: bool = False, momentum: float = shared.BN_MOMENTUM):
        super().__init__(sd, train, quant, momentum)
        self.depth = depth_of(sd)

    def block(self, x, pref, stride=1):
        y = torch.relu(self.bn(self.conv(x, f"{pref}.conv1", stride),
                               f"{pref}.bn1"))
        y = torch.relu(self.bn(self.conv(y, f"{pref}.conv2"), f"{pref}.bn2"))
        if f"{pref}.bypass.weight" in self.sd:
            r = self.bn(self.conv(x, f"{pref}.bypass", stride),
                        f"{pref}.bnpass")
        else:
            r = x
        return torch.relu(y + r)

    def double(self, x, pref, stride=1):
        return self.block(self.block(x, f"{pref}.res1", stride),
                          f"{pref}.res2")

    def deconv(self, x, key, like):
        w = self.sd[f"{key}.weight"]
        th, tw = like.shape[2], like.shape[3]
        op = (th - 2 * x.shape[2], tw - 2 * x.shape[3])
        y = F.conv_transpose2d(self._q(x), self._q(w), stride=2, padding=1,
                               output_padding=(max(op[0], 0), max(op[1], 0)))
        return y[:, :, :th, :tw]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(b, c, h, w) float32 -> (b, classes, h, w) logits."""
        x0 = torch.relu(self.bn(self.conv(x, "conv1"), "bn1"))
        y = F.max_pool2d(x0, 3, 2, 1)
        skips = [x0]
        for i in range(1, self.depth + 1):
            y = self.double(y, f"enc_layer{i}", 1 if i == 1 else 2)
            skips.append(y)
        for i in range(self.depth, 0, -1):
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
