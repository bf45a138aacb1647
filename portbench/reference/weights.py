"""Seeded weights of a configuration's architecture, made on the device
in a few large calls, in the order of its reference's ``layout``.

Convolution and transposed-convolution weights are drawn as the
reference initialises them, normal with std sqrt(2 / (k·k·out)) (the
layout's ``fan_out``; models/ub_uresnet.py:72-79); conv biases as
torch's Conv2d default, uniform in ±1/sqrt(fan_in); BN weight 1 and
bias 0. Random weights with
identity running statistics saturate the scores (logits of 1e3 and more,
every probability 0 or 1), which no comparison can judge, so the running
statistics are set from the data: a float32 forward over a few seeded
crops takes each BatchNorm's batch mean and biased variance as its
running statistics, layer by layer, as a trained network's would
normalise such crops.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.lib import common


def make_state_dict(cfg: dict, seed: int, device, calib_crops: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    """Reference-format float32 state_dict of ``cfg`` (a configuration
    file's dict) on ``device`` from ``seed``; ``calib_crops`` (b, h, w,
    1) float32 on ``device`` set the running statistics."""
    ref = common.reference_module(cfg)
    convs, biases, bns = ref.layout(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [math.prod(s) for _, s, _ in convs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    sd: Dict[str, torch.Tensor] = {}
    for (key, shape, fan_out), part in zip(convs, torch.split(flat, sizes)):
        sd[key] = part.view(shape) * math.sqrt(2.0 / fan_out)
    shapes = {key: shape for key, shape, _ in convs}
    outs = [shapes[key.replace(".bias", ".weight")][0] for key, _ in biases]
    u = torch.rand(sum(outs), generator=gen, device=device)
    for (key, fan_in), part in zip(biases, torch.split(u, outs)):
        sd[key] = (2 * part - 1) / math.sqrt(fan_in)
    for key, c in bns:
        sd[f"{key}.weight"] = torch.ones(c, device=device)
        sd[f"{key}.bias"] = torch.zeros(c, device=device)
        sd[f"{key}.running_mean"] = torch.zeros(c, device=device)
        sd[f"{key}.running_var"] = torch.ones(c, device=device)
    calibrate(ref.Net, sd, calib_crops)
    return sd


def calibrate(net_cls, sd: Dict[str, torch.Tensor], crops: torch.Tensor
              ) -> None:
    """Set every BN's running statistics to its batch statistics over
    ``crops`` under ``net_cls``, in float32 with TF32 off (the flags are
    put back)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            net_cls(sd, train=True, momentum=1.0)(
                crops.float().permute(0, 3, 1, 2))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
