"""Operations and bytes of the kernel-zone layers, and the model's
FLOPs.

A frozen copy of the port's kernel-row arithmetic
(chip_smoke.py:kernel_rows and train_kernel_rows): bytes count each
input read once and each output written once, bf16 activations and
weights (K6's dW f32), operations are 2·MACs on the tensor cores (the
pool and the loss on the float32 pipes); a layer's bound is
max(bytes / 3.35 TB/s, operations / peak), the H100 SXM's published
rates at 700 W. Which layers run on which kernel is data: the list in
``work/<config>.json`` (the layers the port routes to its kernels,
models/blocks.py, at the configuration's widths).

The model's FLOPs are counted from the configuration's plain reference
(``reference/<arch>.py``): every convolution and transposed convolution
it performs, 2·MACs, whatever implements them in the port; a training
step counts three forwards, no recompute.
"""
from __future__ import annotations

from typing import Dict, List

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores


def _row(layer, kernel, nbytes, ops, peak, launches=1) -> dict:
    bound = max(nbytes / HBM_BYTES_PER_S, ops / peak)
    return {"layer": layer, "kernel": kernel, "bytes": nbytes, "ops": ops,
            "peak": peak, "bound_s": bound, "launches": launches,
            "by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak
            else "ops"}


def eval_rows(entries: List[dict], B: int, hw) -> List[dict]:
    """One row a kernel-zone layer of the eval forward at batch ``B`` and
    input ``hw``; ``entries`` as in ``work/<config>.json``'s ``eval``."""
    H, W = hw
    rows = []
    for e in entries:
        h, w = H // e["div"], W // e["div"]
        pix = B * h * w
        kind, name = e["kind"], e["layer"]
        if kind == "pool":
            (c,) = e["shape"]
            out = B * (h // 2) * (w // 2) * c
            rows.append(_row(name, "maxpool3x3s2", pix * c * 2 + out * 2,
                             8 * out, F32_FLOPS))
        elif kind == "block":
            ca, cb, co, proj = e["shape"]
            cin = ca + cb
            macs = pix * (9 * cin * co + 9 * co * co
                          + (cin * co if proj else 0))
            nbytes = (pix * cin * 2 + pix * co * 2 + 9 * cin * co * 2
                      + 9 * co * co * 2)
            rows.append(_row(name, "basic_block", nbytes, 2 * macs,
                             BF16_TENSOR_FLOPS))
        elif kind == "deconv":
            ci, co = e["shape"]
            out_pix = 4 * pix
            nbytes = pix * ci * 2 + out_pix * co * 2 + 16 * ci * co * 2
            rows.append(_row(name, "deconv2x", nbytes,
                             2 * out_pix * 4 * ci * co, BF16_TENSOR_FLOPS))
        elif kind == "conv":
            ci, co, k = e["shape"]
            rows.append(_row(name, "conv_bn_act",
                             pix * (ci + co) * 2 + k * k * ci * co * 2,
                             2 * pix * k * k * ci * co, BF16_TENSOR_FLOPS))
        else:
            raise ValueError(f"unknown eval layer kind {kind!r}")
    return rows


def train_rows(entries: List[dict], B: int, hw, classes: int) -> List[dict]:
    """The kernel-zone work of one training step: per zone conv K5
    forward, K1 input gradient and K6 weight gradient (``count`` of
    each); the classifier's K1 forward, K1 input gradient and K6; the
    stem pool's K4; the loss's K7 forward and backward."""
    H, W = hw
    rows = []
    for e in entries:
        kind, name = e["kind"], e["layer"]
        h, w = H // e["div"], W // e["div"]
        pix = B * h * w
        n = e.get("count", 1)
        if kind in ("zone_conv", "classifier"):
            ci, co, k = e["shape"]
            macs = pix * k * k * ci * co
            act = pix * (ci + co) * 2
            if kind == "zone_conv":
                rows.append(_row(f"{name} K5", "conv_stats",
                                 act + k * k * ci * co * 2 + co * 8,
                                 2 * macs, BF16_TENSOR_FLOPS, n))
            else:
                rows.append(_row(f"{name} forward", "conv_bn_act",
                                 act + k * k * ci * co * 2, 2 * macs,
                                 BF16_TENSOR_FLOPS, n))
            rows.append(_row(f"{name} dx", "conv_bn_act",
                             act + k * k * ci * co * 2, 2 * macs,
                             BF16_TENSOR_FLOPS, n))
            rows.append(_row(f"{name} dW", "conv_dw",
                             act + k * k * ci * co * 4, 2 * macs,
                             BF16_TENSOR_FLOPS, n))
        elif kind == "pool":
            (c,) = e["shape"]
            out = B * (h // 2) * (w // 2) * c
            rows.append(_row(name, "maxpool3x3s2", pix * c * 2 + out * 2,
                             8 * out, F32_FLOPS, n))
        elif kind == "loss":
            C = classes
            rows.append(_row(f"{name} forward", "weighted_nll",
                             pix * (4 * C + 4 + 4) + 4, (7 * C - 1) * pix,
                             F32_FLOPS))
            rows.append(_row(f"{name} backward", "weighted_nll",
                             pix * (4 * C + 4 + 4 + 4 * C), 10 * C * pix,
                             F32_FLOPS))
        else:
            raise ValueError(f"unknown train layer kind {kind!r}")
    return rows


def by_kernel(rows: List[dict]) -> Dict[str, dict]:
    """{kernel: {launches, bound_s}} of one call (forward or step)."""
    out: Dict[str, dict] = {}
    for r in rows:
        k = out.setdefault(r["kernel"], {"launches": 0, "bound_s": 0.0})
        k["launches"] += r["launches"]
        k["bound_s"] += r["launches"] * r["bound_s"]
    return out


def forward_macs(cfg: dict, hw) -> int:
    """MACs of one crop's forward: every F.conv2d and F.conv_transpose2d
    that the configuration's plain reference calls at input ``hw``,
    counted on shape-only tensors. A convolution costs out.numel() / N ·
    (C_in / groups) · kh · kw, a transposed one in.numel() / N · (C_out /
    groups) · kh · kw (either way the weight's numel over its dim 0);
    stride and dilation show in the sizes."""
    import torch
    from torch.overrides import TorchFunctionMode

    from portbench.lib import common

    ref = common.reference_module(cfg)
    convs, biases, bns = ref.layout(cfg)
    meta = torch.device("meta")
    sd = {k: torch.empty(s, device=meta) for k, s, _ in convs}
    for k, _ in biases:
        sd[k] = torch.empty(sd[k.replace(".bias", ".weight")].shape[0],
                            device=meta)
    for k, c in bns:
        for p in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{k}.{p}"] = torch.empty(c, device=meta)

    class Counting(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func in (torch.conv2d, torch.conv_transpose2d):
                x = args[0] if args else kwargs["input"]
                w = args[1] if len(args) > 1 else kwargs["weight"]
                per = out if func is torch.conv2d else x
                self.total += per[0].numel() * w[0].numel()
            return out

    with Counting() as count:
        ref.Net(sd)(torch.empty(1, cfg["input_channels"], *hw, device=meta))
    return count.total
