"""Seeded UResNet weights, made on the device in a few large calls.

Convolution and transposed-convolution weights are drawn as the
reference initialises them, normal with std sqrt(2 / (k·k·out))
(models/ub_uresnet.py:72-79); conv biases as torch's Conv2d default,
uniform in ±1/sqrt(fan_in); BN weight 1 and bias 0. Random weights with
identity running statistics saturate the scores (logits of 1e3 and more,
every probability 0 or 1), which no comparison can judge, so the running
statistics are set from the data: a float32 forward over a few seeded
crops takes each BatchNorm's batch mean and biased variance as its
running statistics, layer by layer, as a trained network's would
normalise such crops.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference.uresnet import Net

Shape = Tuple[int, ...]


def layout(inplanes: int, depth: int, num_classes: int,
           input_channels: int = 1, final_conv_kernels: int = 16
           ) -> Tuple[List[Tuple[str, Shape]], List[Tuple[str, int]],
                      List[Tuple[str, int]]]:
    """(conv weights [(key, shape)], conv biases [(key, fan_in)], BNs
    [(key, channels)]) of a UResNet under the reference's key names.
    Weight shapes: conv (out, in, k, k), transposed conv (in, out, 4, 4)."""
    convs: List[Tuple[str, Shape]] = []
    biases: List[Tuple[str, int]] = []
    bns: List[Tuple[str, int]] = []

    def conv(key, co, ci, k, bn=None, bias=False):
        convs.append((f"{key}.weight", (co, ci, k, k)))
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
    conv("conv1", inplanes, input_channels, 7, "bn1", bias=True)
    for i in range(1, depth + 1):
        block(f"enc_layer{i}.res1", chans[i - 1], chans[i], 1 if i == 1 else 2)
        block(f"enc_layer{i}.res2", chans[i], chans[i], 1)
    for i in range(depth, 0, -1):
        ci, cu = chans[i], chans[i - 1]
        convs.append((f"dec_layer{i}.deconv.weight", (ci, cu, 4, 4)))
        block(f"dec_layer{i}.res.res1", 2 * cu, cu, 1)
        block(f"dec_layer{i}.res.res2", cu, cu, 1)
    conv("conv10", final_conv_kernels, inplanes, 7, "bn10", bias=True)
    conv("conv11", num_classes, final_conv_kernels, 7, bias=True)
    return convs, biases, bns


def _fan_out(key: str, shape: Shape) -> int:
    """k·k·out of the reference's init (out is dim 1 of a transposed
    conv's weight)."""
    k = shape[-1]
    return k * k * (shape[1] if key.endswith("deconv.weight") else shape[0])


def make_state_dict(cfg: dict, seed: int, device, calib_crops: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Reference-format float32 state_dict of ``cfg`` (a configuration
    file's dict) on ``device`` from ``seed``; ``calib_crops`` (b, h, w,
    1) float32 on ``device`` set the running statistics."""
    convs, biases, bns = layout(cfg["inplanes"], cfg["depth"],
                                cfg["num_classes"], cfg["input_channels"],
                                cfg["final_conv_kernels"])
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for _, s in convs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    sd: Dict[str, torch.Tensor] = {}
    for (key, shape), part in zip(convs, torch.split(flat, sizes)):
        sd[key] = part.view(shape) * math.sqrt(2.0 / _fan_out(key, shape))
    shapes = dict(convs)
    outs = [shapes[key.replace(".bias", ".weight")][0] for key, _ in biases]
    u = torch.rand(sum(outs), generator=gen, device=device)
    for (key, fan_in), part in zip(biases, torch.split(u, outs)):
        sd[key] = (2 * part - 1) / math.sqrt(fan_in)
    for key, c in bns:
        sd[f"{key}.weight"] = torch.ones(c, device=device)
        sd[f"{key}.bias"] = torch.zeros(c, device=device)
        sd[f"{key}.running_mean"] = torch.zeros(c, device=device)
        sd[f"{key}.running_var"] = torch.ones(c, device=device)
    calibrate(sd, calib_crops)
    return sd


def calibrate(sd: Dict[str, torch.Tensor], crops: torch.Tensor) -> None:
    """Set every BN's running statistics to its batch statistics over
    ``crops``, in float32 with TF32 off (the flags are put back)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            Net(sd, train=True, momentum=1.0)(
                crops.float().permute(0, 3, 1, 2))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
