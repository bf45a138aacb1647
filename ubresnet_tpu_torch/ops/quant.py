"""int8 post-training quantization (counterpart of
ubresnet_tpu/ops/quant.py): symmetric per-output-channel weight scales,
scalar activation scales calibrated on a few eval batches, and the
exact integer convolutions of the plain int8 routes; and the QAT
fake-quantizers (``fake_quant_weight``, ``fake_quant_act``) that
``Policy.quant_train`` puts at the same layers' inputs and kernels.

Numerics follow the JAX package operation for operation, in float32:
rounding is half to even (``torch.round``, as ``jnp.round`` and CUDA's
``rintf``), an activation is divided by its scale (``x / sx``, never
multiplied by ``1 / sx``, which moves values across .5 boundaries), and
a percentile is the linear interpolation of ``jnp.nanpercentile``
written out on the sorted nonzero |x|.

``calibrate`` runs the model's unfused forward (``fused_eval`` and
``quant_eval`` off, as JAX calibrates) and records, per layer under its
JAX name, the input of every ConvBN (the [up, skip] concat for a
decoder block's res1, the conv1 output for cb2) and of every Deconv2x;
a scale is the running max over batches of range / 127. The model takes
the result through its ``set_quant_scales``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterable

import torch
import torch.nn.functional as F

INT8_MAX = 127.0
# above this many elements a percentile is taken on a strided grid of
# the tensor (JAX commit 651980a: a full sort ran out of memory)
CALIB_CAP = 1 << 20
# an integer conv whose reduction (ci·k·k) is at most this runs as an
# unfold and a float32 matmul: every partial sum stays below
# 64·127·127 < 2^24, so float32 holds it exactly in any order
SMALL_REDUCTION = 64


def packed_view(x: torch.Tensor, p: int) -> torch.Tensor:
    """The JAX package's W-packed view (b, h, w/p, p·c) of an NHWC
    tensor — a reshape. Calibration of a packed-zone layer sees this
    shape, which fixes the strided subsample's grid."""
    if p <= 1:
        return x
    b, h, w, c = x.shape
    return x.reshape(b, h, w // p, p * c)


def _subsample(x: torch.Tensor) -> torch.Tensor:
    """Strided grid over the leading axes (the last stays whole) down to
    about CALIB_CAP elements — ubresnet_tpu/ops/quant.py:55-70."""
    need = x.numel() / CALIB_CAP
    slices = []
    for i, n in enumerate(x.shape):
        last = i == x.dim() - 1
        if need <= 1 or (last and x.dim() > 1):
            slices.append(slice(None))
            continue
        rest = max(1, (x.dim() if x.dim() == 1 else x.dim() - 1) - i)
        s = max(1, min(n, math.ceil(need ** (1.0 / rest))))
        slices.append(slice(None, None, s))
        need /= s
    return x[tuple(slices)]


def calib_batch_range(x: torch.Tensor, percentile: float = 0.0
                      ) -> torch.Tensor:
    """The |x| range one calibration batch contributes to a layer's
    scale, a float32 scalar: abs-max when ``percentile`` is 0, else the
    percentile of the NONZERO |x| (0 when there are none)."""
    if not percentile:
        return x.float().abs().max()
    if x.numel() > CALIB_CAP:
        x = _subsample(x)
    ax = x.float().abs().flatten()
    vals = torch.sort(ax[ax > 0]).values
    n = vals.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    # jnp.nanpercentile, method 'linear', in float32, as XLA compiles it
    # inside a jitted caller: q / 100 folded exactly, the interpolation
    # lo·lw + hi·hw as one FMA over the rounded lo·lw
    q = torch.tensor(percentile, dtype=torch.float32) / 100.0
    q = q * (torch.tensor(float(n), dtype=torch.float32) - 1.0)
    low, high = torch.floor(q), torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    lo = vals[int(min(max(low.item(), 0), n - 1))]
    hi = vals[int(min(max(high.item(), 0), n - 1))]
    return fma(hi, hw.to(hi.device), lo * lw.to(lo.device))


def weight_scales(w: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-output-channel symmetric scales of a (kh, kw, ci, co) kernel:
    the co-vector s with w ≈ s · round(w / s)."""
    return torch.clamp_min(w.float().abs().amax(dim=(0, 1, 2)), eps) / INT8_MAX


def quantize_weight(w: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """Round a (kh, kw, ci, co) kernel to int8 with per-co scales."""
    return torch.round(w.float() / sw).to(torch.int8)


def quantize_act(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization of an activation tensor with a scalar
    scale (clips to ±127)."""
    y = x.float() / sx
    return y.clamp_(-INT8_MAX, INT8_MAX).round_().to(torch.int8)


# The QAT fake-quantizers follow the JAX package's functions as its
# models run them, under jit, where XLA compiles every ``/ 127`` as a
# multiply by the rounded reciprocal: bit for bit.
INV_INT8_MAX = 1.0 / INT8_MAX


def _inv127(t: torch.Tensor) -> torch.Tensor:
    # a Python number: rounded to float32 as the product is, and no
    # host-to-card copy (a CUDA graph cannot capture one)
    return t * INV_INT8_MAX


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """QAT fake-quantization of a (kh, kw, ci, co) kernel: round to the
    per-output-channel int8 grid and dequantize, in float32, with an
    identity straight-through gradient (the scales track the live
    weights, so nothing clips); output in ``w.dtype``."""
    wf = w.float()
    sw = _inv127(torch.clamp_min(wf.detach().abs().amax(dim=(0, 1, 2)),
                                 1e-12))
    wq = torch.round(wf / sw) * sw
    return (wf + (wq - wf).detach()).to(w.dtype)


def fake_quant_act(x: torch.Tensor, percentile: float = 0.0,
                   pack: int = 1) -> torch.Tensor:
    """QAT fake-quantization of an activation with a dynamic per-batch
    scale s = range / 127 (``calib_batch_range`` of ``packed_view(x,
    pack)``, the shape JAX's packed ConvBN sees, detached): clip to
    [-lim, lim] with lim = s·127 through a where — gradient exactly 1
    inside, ties at the bound included, 0 outside —, round to the grid,
    dequantize, straight through. An all-zero batch (s = 0) passes
    unchanged. float32 math, output in ``x.dtype``."""
    xf = x.float()
    s = _inv127(calib_batch_range(packed_view(xf.detach(), pack),
                                  percentile))
    lim = s * INT8_MAX
    xc = torch.where(xf.abs() <= lim, xf, torch.sign(xf) * lim)
    xq = torch.round(xc / torch.clamp_min(s, 1e-12)) * s
    y = xc + (xq - xc).detach()
    return torch.where(s > 0, y, xf).to(x.dtype)


def fma(a: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·g + b rounded once to float32, as a fused multiply-add: XLA
    compiles the JAX package's ``acc * g + b`` epilogues that way and
    the int8 kernels use fmaf. Through float64, whose product of two
    float32 values is exact (a second rounding could differ from the
    FMA's one only on an exact float32 tie, ~2^-29 of the cases): one
    float64 pass, ``a`` promoted inside it."""
    return torch.addcmul(b.double(), a, g.double()).float()


@contextlib.contextmanager
def _full_f32_matmul():
    """float32 matmuls in full float32 (no TF32 on the card, no reduced
    precision on the CPU) for the duration."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def int_conv2d(xq: torch.Tensor, wq: torch.Tensor, pad: int,
               stride: int = 1) -> torch.Tensor:
    """Exact s8 x s8 → s32 conv of NHWC ``xq`` with a (kh, kw, ci, co)
    ``wq`` at ``stride``, returned as float32 NHWC (exact: every sum
    of this network's shapes is below 2^24). Computed in float64 and
    rounded, so any convolution algorithm gives the exact integers, on
    the CPU and on the card alike (where a float32 convolution may run
    in TF32 or through a Winograd/FFT transform). A small reduction
    (ci·k·k ≤ SMALL_REDUCTION: the 1-channel 7x7 stem) runs instead as
    an unfold and one float32 matmul in full float32, exact because its
    integer partial sums stay below 2^24 — an order of magnitude less
    device time than the float64 convolution."""
    k, _, ci, co = wq.shape
    if ci * k * k <= SMALL_REDUCTION:
        b, h, w, _ = xq.shape
        cols = F.unfold(xq.permute(0, 3, 1, 2).float(), k, padding=pad,
                        stride=stride)
        w2 = wq.permute(3, 2, 0, 1).reshape(co, ci * k * k).float()
        with _full_f32_matmul():
            acc = torch.matmul(cols.transpose(1, 2), w2.t())
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        return acc.view(b, ho, wo, co)
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                 wq.permute(3, 2, 0, 1).double(), padding=pad, stride=stride)
    return y.round().float().permute(0, 2, 3, 1).contiguous()


def int_conv_transpose2d(xq: torch.Tensor, wq: torch.Tensor,
                         target_hw=None) -> torch.Tensor:
    """Exact s8 x s8 → s32 ConvTranspose2d(k=4, s=2, p=1) of NHWC ``xq``
    with a (4, 4, ci, co) ``wq`` (no spatial flip: torch semantics), as
    float32 NHWC; float64 and rounded, as ``int_conv2d``. ``target_hw``
    (default 2x) takes an output_padding and a high-side crop, as
    models/blocks.py:deconv_to does for the float deconv."""
    h, w = xq.shape[1], xq.shape[2]
    th, tw = (2 * h, 2 * w) if target_hw is None else target_hw
    pads = []
    for d, t in ((h, th), (w, tw)):
        if not 2 * d - 2 <= t <= 2 * d + 1:
            raise ValueError(f"deconv target size {t} unreachable from "
                             f"input {d}")
        pads.append(max(0, t - 2 * d))
    y = F.conv_transpose2d(xq.permute(0, 3, 1, 2).double(),
                           wq.permute(2, 3, 0, 1).double(), stride=2,
                           padding=1, output_padding=tuple(pads))
    y = y[:, :, :th, :tw]
    return y.round().float().permute(0, 2, 3, 1).contiguous()


def calibrate(model, batches: Iterable, percentile: float = None
              ) -> Dict[str, torch.Tensor]:
    """Activation scales of ``model`` (a port eval model, UResNet or
    ASPP-ResNet: ``policy``, ``calibration_model()``, ``observe``,
    ``packed_zone``) from eval forwards over ``batches`` (dense NHWC
    images, numpy or torch): {JAX layer name: float32 scalar}, e.g.
    ``enc1.res1.cb1`` or ``aspp3.b1``.
    ``percentile`` overrides the policy's ``quant_percentile``."""
    pct = model.policy.quant_percentile if percentile is None else percentile
    cal = model.calibration_model()
    scales: Dict[str, torch.Tensor] = {}
    packed = [False]

    def record(name: str, x: torch.Tensor, pack: int) -> None:
        view = packed_view(x, pack) if packed[0] else x
        r = (calib_batch_range(view, pct) / INT8_MAX).cpu()
        scales[name] = r if name not in scales else torch.maximum(
            scales[name], r)

    seen = 0
    cal.observe(record)
    try:
        with torch.inference_mode():
            for x in batches:
                x = torch.as_tensor(x, dtype=torch.float32).to(cal.device)
                packed[0] = cal.packed_zone(x.shape[2])
                cal(x)
                seen += 1
    finally:
        cal.observe(None)
    if not seen:
        raise ValueError("calibrate() needs at least one batch")
    return scales
