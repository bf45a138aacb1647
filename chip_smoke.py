#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ubresnet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi); no card,
             no run: without CUDA the script exits 1 before anything.
2. build   — nvcc builds the twelve Hopper kernels from
             ubresnet_tpu_torch/ops/csrc for sm_90a (-Xptxas -v): every
             kernel's registers, spills and static shared memory.
3. kernels — every kernel-zone layer of the flagship UResNet at its
             main-path shape and batch (16): the kernel against its plain
             PyTorch version on the same bf16 inputs, the kernel's, the
             plain version's and the library call's time (CUDA events),
             and the bound from the bytes and operations. Eval rows (K1-K4,
             max abs error ≤ 1e-2·max|plain| for K1-K3 — one bf16 rounding
             of the output —, exact for K4), int8 rows (K1-s8 head, K2-s8
             ×6, K3-s8 ×2 on int8 inputs: the float32 output bit-identical
             to the plain version's — exact s32 sums, with g = 1, b = 0
             for the conv and deconv the accumulator itself —, the bf16
             output within one bf16 step; bound from the int8 tensor-core
             rate; library_ms null — no PyTorch call computes an int8
             conv — with the same layer's bf16 kernel and cuDNN bf16
             times beside it) and train rows: K5 (y as K1;
             its f32 sums of the bf16 y ≤ 1e-3·max|plain|, where one bf16
             step of some y may differ), K1 as the input gradient (as K1),
             K6 (f32 dW ≤ 1e-3·max|plain|: sums over 1-4 M pixels in
             another order), K7 forward and backward (f32, ≤ 1e-5·max);
             deconv-AD rows at dec2's and dec1's b16 shapes: K8 (dx, as
             K1), K9 (f32 dW ≤ 1e-3·max|plain|, as K6; its and the plain
             version's distance from a float64 dW reported) and deconv2x_ad
             forward + backward against F.conv_transpose2d's f32
             autograd (y, dx and the bf16 dW each ≤ 1e-2·max|plain|).
             Each row also gives pct_of_bound (bound_ms / ms) and
             vs_library (ms / library_ms); K1, K5, K6, K8, K9 and the
             int8 rows also the ptxas registers, spills and stack of the
             kernel instance they launch, and K5, K8 and K9 rows launch
             twice and require the same bits (same_bits). K1, K2, K3,
             K5, K6, K8 and K9 are bf16 tensor-core kernels (mma.sync
             m16n8k16, f32 accumulators), K1-s8, K2-s8 and K3-s8 int8
             ones (m16n8k32, exact s32 accumulators: K1-s8 runs K1's
             mainloop with two 7x7 taps a 32-deep k-step, K2-s8 and
             K3-s8 carry K2's and K3's designs), each in a persistent
             grid: each block walks its tiles, the next tile's input
             arriving by double-buffered cp.async; all but K4, K6, K7
             and K9 stage their layer's weights in shared memory once
             per block, K2 and K2-s8 keep m (with its halo) on chip, K3
             and K3-s8 compute all four output parity classes of a tile
             from one read of its input, K5 is K1's mainloop with the
             sums of its bf16 y kept per lane and reduced per block in a
             fixed order, K8 and K9
             read each haloed dy tile as its four parity planes (each
             tap one plane at stride 1), K6 and K9 keep their block's
             share of dW in registers (dW = x_shiftᵀ·dy per tile, or
             x_tileᵀ·dy_tap per tap, both operands by ldmatrix.trans).
             The eval and int8 rows again at the wholeview paths' cells:
             b10 512x832 (one stitched chunk of crops) and b1 1024x3456
             (the spatial path's padded plane), under the same checks.
4. main    — 64 synthetic 512x512 crops scored file → file through the
             port's CLI (-b 16, cuda) with seeded random weights in a
             reference-format .tar; every event must carry 3 score
             images summing to 1 ± 1e-2, every kernel must have run its
             11-launches-per-batch share, and the kernel path must
             agree with the plain f32 path (TF32 off) on the argmax of
             the 16 crops of the timed forward for ≥ 99% of pixels.
             Also forward-only crops/s, the stage breakdown and a
             torch.profiler view of the b16 forward (device busy and idle
             shares, largest kernels), and a second, warm CLI run.
5. train_parity — one seeded 512² batch of 16, the same weights: the
             train kernel path (bf16), the plain path (bf16, fused_train
             off) and the f32 plain path (TF32 off): loss and every
             parameter gradient. Gates: the kernel path is no further
             from the f32 path than twice the plain bf16 path is (loss
             and max|Δgrad|/max|grad|, with floors 1e-3 and 1e-2). Then
             5 Adam steps (lr 1e-3) on the batch: the loss must fall;
             steps 2-5 timed with CUDA events. A torch.profiler trace
             of 2 more steps gives the zone kernels' device time per
             step, the busy and idle shares and the largest other
             kernels (reported, not gated).
   train_deconv — the same batch and weights through the train step
             with Policy.fused_train_deconv (K3 forward, K8 dx, K9 dW at
             dec2 and dec1): loss and gradients under the same gates
             against the same plain paths, then 5 Adam steps whose
             launches are exactly 5 × (K5 16, K1 18, K6 17, K4 1, K7
             1 + 1, K3 2, K8 2, K9 2); the loss must fall. Step ms beside
             the default zone's, the profiler's K3/K8/K9 device time per
             step, and deconv2x_ad forward + backward against cuDNN's
             from the kernel rows (reported).
6. train   — the port's training CLI (--device cuda) on 64 synthetic
             512² events: batch 16, 8 iterations, validation every 4
             (1 batch), checkpoints every 4, the default sparse
             transfer. Gates: no error, final_iter 8, a finite loss at
             every iteration, launch counts = the per-step table × 8
             (K5 16, K1 18, K6 17, K4 1, K7 1 + 1) + 11 per validation
             forward, and the final .tar scores a crop through the eval
             model with probability sums 1 ± 1e-2.
   qat     — the training CLI with --set model.qat=true on the same
             64 events: 4 iterations, one validation (fake-quantized,
             per-conv blocks: no K2); launches exactly 4 × the step table
             + K4 1, K3 2, K1 2; finite losses; the final .tar scores a
             crop with probability sums 1 ± 1e-2. Then the int8 ladder
             (python -m ubresnet_tpu_torch.tools.int8_ladder 10, 512²,
             batch 32): its JSON, reported, not gated.
7. int8    — the deploy smoke's 64 crops through the CLI with --int8
             (calibrated on the first 32, -b 16, cuda): launch counts
             exactly K1-s8 1, K2-s8 6, K3-s8 2, K4 1, K1 1 per batch,
             score sums 1 ± 1e-2; on one b16 batch the int8 kernel path
             against the int8 plain path with the same scales (argmax
             ≥ 0.99), int8 vs bf16 forward ms and their ratio, the int8
             stage breakdown,
             and (not gated: random weights) mean|Δp| and argmax
             agreement against the f32 path for abs-max and
             percentile-99.9 scales.
8. wholeview — 4 synthetic whole planes (1008x3456, seed 0) through
             python -m ubresnet_tpu_torch.cli.infer_wholeview --device
             cuda: spatial (the default: first, warm, --f16-scores),
             --stitched and --int8 --int8-calib 2. Gates: 3
             ubsnet_plane2 images of 1008x3456 per event summing to
             1 ± 1e-2; launches exactly 11 per plane (spatial), 11 per
             10-crop chunk (stitched, one chunk a plane), the int8
             table per plane;
             on one plane the kernel path against the f32 plain path
             (TF32 off), spatial and stitched, and the int8 kernel path
             against the int8 plain path on the same scales, argmax
             ≥ 0.99. Reported: planes/s, the timing dicts, forward ms
             per plane, the spatial forward's stages and profile, peak
             memory.
9. serve   — python -m ubresnet_tpu_torch.cli.serve --once --device
             cuda over two precropped files of 16 crops and a corrupt
             file (-b 16), then over one whole-plane file of 2 events
             (--wholeview). Gates: the good files served (score sums
             1 ± 1e-2), the corrupt one quarantined (.failed), the
             shutdown line, launches exactly 11 per batch and per plane.
10. summary — the kernels line (K1-K9, K1-s8, K2-s8, K3-s8) with the
             launches of every path (wholeview and serve among them), the
             times at the main cell and, under at_shapes, at the
             wholeview cells; the card line, the result line.

Scratch files go under build/chip_smoke in the checkout.
"""
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
INT8_TENSOR_OPS = 1979e12   # H100 SXM dense int8 tensor cores
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
EVENTS, BATCH_MAIN, HW = 64, 16, (512, 512)
MAIN_CELL = f"b{BATCH_MAIN} {HW[0]}x{HW[1]}"
# wholeview: synthetic whole planes (1008x3456, plane 2), the zone's
# batch and input at the stitched path's crop chunk (10 crops of
# 512x832) and the spatial path's padded plane (1 x 1024x3456)
WV_EVENTS, WV_HW, WV_CALIB = 4, (1008, 3456), 2
WV_SHAPES = ((10, (512, 832)), (1, (1024, 3456)))
SERVE_CROPS = 16            # events in each precropped file of the serve run
INT8_CALIB = 32             # --int8-calib: crops the CLI calibrates on
LAUNCHES_PER_BATCH = {"conv_bn_act": 2, "basic_block": 6, "deconv2x": 2,
                      "maxpool3x3s2": 1}
# the int8 forward: 9 of its 11 launches int8 (2 of the 6 blocks dual)
LAUNCHES_PER_BATCH_INT8 = {"conv_bn_act_s8": 1, "basic_block_s8": 6,
                           "deconv2x_s8": 2, "maxpool3x3s2": 1,
                           "conv_bn_act": 1}
LAUNCHES_PER_TRAIN_STEP = {"conv_stats": 16, "conv_bn_act": 18,
                           "conv_dw": 17, "maxpool3x3s2": 1,
                           "weighted_nll": 1, "weighted_nll_bwd": 1}
# with Policy.fused_train_deconv: the decoder upsamples' three legs
LAUNCHES_PER_DECONV_STEP = {**LAUNCHES_PER_TRAIN_STEP, "deconv2x": 2,
                            "conv_s2k4": 2, "deconv_dw": 2}
# a validation forward under QAT: blocks per conv (cuDNN), no K2
LAUNCHES_PER_QAT_VALID = {"conv_bn_act": 2, "deconv2x": 2,
                          "maxpool3x3s2": 1}
TRAIN_ITERS, VALID_EVERY = 8, 4
QAT_ITERS, LADDER_STEPS = 4, 10
# kernels line entry → (source, the TPU kernel it replaces, row kernels,
# the paths that must launch it)
PALLAS = "ubresnet_tpu/ops/pallas_conv.py"
SOURCES = {
    "conv_bn_act": ("ubresnet_tpu_torch/ops/csrc/conv_bn_act.cu",
                    f"{PALLAS}:315 fused_packed_conv"
                    " + :1811 pallas_conv_ad (forward, dx)",
                    ("conv_bn_act",),
                    ("precropped", "train", "train_deconv", "qat", "int8",
                     "wholeview", "serve")),
    "basic_block": ("ubresnet_tpu_torch/ops/csrc/basic_block.cu",
                    f"{PALLAS}:1483 fused_basic_block"
                    " + :699 fused_dual_block", ("basic_block",),
                    ("precropped", "train", "wholeview", "serve")),
    "deconv2x": ("ubresnet_tpu_torch/ops/csrc/deconv2x.cu",
                 f"{PALLAS}:898 fused_packed_deconv2x"
                 " + :1341 pallas_deconv2x_ad (forward)",
                 ("deconv2x",), ("precropped", "train", "train_deconv",
                                 "qat", "wholeview", "serve")),
    "maxpool3x3s2": ("ubresnet_tpu_torch/ops/csrc/maxpool3x3s2.cu",
                     f"{PALLAS}:525 fused_pool3x3s2"
                     " + ubresnet_tpu/ops/pool_ad.py:133 packed_pool_ad "
                     "(forward)", ("maxpool3x3s2",),
                     ("precropped", "train", "train_deconv", "qat", "int8",
                      "wholeview", "serve")),
    "conv_stats": ("ubresnet_tpu_torch/ops/csrc/conv_stats.cu",
                   "ubresnet_tpu/ops/pallas_train.py:206 train_conv_stats",
                   ("conv_stats",), ("train", "train_deconv", "qat")),
    "conv_dw": ("ubresnet_tpu_torch/ops/csrc/conv_dw.cu",
                f"{PALLAS}:1677 pallas_conv_dw", ("conv_dw",),
                ("train", "train_deconv", "qat")),
    "weighted_nll": ("ubresnet_tpu_torch/ops/csrc/weighted_nll.cu",
                     "ubresnet_tpu/ops/pallas_loss.py:100 "
                     "pallas_weighted_nll", ("weighted_nll",
                                             "weighted_nll_bwd"),
                     ("train", "train_deconv", "qat")),
    "conv_s2k4": ("ubresnet_tpu_torch/ops/csrc/conv_s2k4.cu",
                  f"{PALLAS}:1148 fused_conv_s2k4 (the dx leg of :1341 "
                  "pallas_deconv2x_ad)", ("conv_s2k4",), ("train_deconv",)),
    "deconv_dw": ("ubresnet_tpu_torch/ops/csrc/deconv_dw.cu",
                  f"{PALLAS}:1265 pallas_deconv_dw (the dW leg of :1341 "
                  "pallas_deconv2x_ad)", ("deconv_dw",), ("train_deconv",)),
    "conv_bn_act_s8": ("ubresnet_tpu_torch/ops/csrc/conv_bn_act_s8.cu",
                       f"{PALLAS}:315 fused_packed_conv (_conv_kernel :251,"
                       " quantized :282-300)", ("conv_bn_act_s8",),
                       ("int8", "wholeview")),
    "basic_block_s8": ("ubresnet_tpu_torch/ops/csrc/basic_block_s8.cu",
                       f"{PALLAS}:1483 fused_basic_block (_block_kernel "
                       ":1372) + :699 fused_dual_block (_dual_block_kernel"
                       " :587), quantized", ("basic_block_s8",),
                       ("int8", "wholeview")),
    "deconv2x_s8": ("ubresnet_tpu_torch/ops/csrc/deconv2x_s8.cu",
                    f"{PALLAS}:898 fused_packed_deconv2x (_deconv_kernel "
                    ":847), quantized", ("deconv2x_s8",),
                    ("int8", "wholeview")),
}
# the train zone at batch 16: (ci, co, k) of each distinct conv, the
# resolution it runs at and how many of the step's 16 BN-fed zone convs
# have that shape (models/uresnet.py:TrainUResNet)
TRAIN_ZONE = [((16, 32, 3), 256, 1), ((16, 32, 1), 256, 1),
              ((32, 32, 3), 256, 6), ((64, 32, 3), 256, 1),
              ((64, 32, 1), 256, 1), ((32, 16, 3), 512, 1),
              ((32, 16, 1), 512, 1), ((16, 16, 3), 512, 3),
              ((16, 16, 7), 512, 1)]
CLASSIFIER = ((16, 3, 7), 512, 1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, budget_ms=150.0):
    """Mean ms per call over a CUDA-event-timed loop after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = max(3, min(50, int(budget_ms / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _max_err(got, want):
    return (float((got.float() - want.float()).abs().max()),
            float(want.float().abs().max()))


def bf16_check(got, want):
    """One bf16 rounding step of the output: ≤ 1e-2·max|plain|."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"kernel {tuple(got.shape)} {got.dtype} vs plain "
            f"{tuple(want.shape)} {want.dtype}")
    err, ref = _max_err(got, want)
    return err, ref, 1e-2 * ref, {}


def exact_check(got, want):
    err, ref = _max_err(got, want)
    return err, ref, 0.0, {}


def f32_check(rel):
    def check(got, want):
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"kernel {tuple(got.shape)} {got.dtype} vs plain "
                f"{tuple(want.shape)} {want.dtype}")
        err, ref = _max_err(got, want)
        return err, ref, rel * ref, {}
    return check


def stats_check(got, want):
    """K5: y as a bf16 output; s1 and s2 (f32 sums of the bf16 y) within
    1e-3·max|plain| each (reported beside y's error). Also reported, not
    gated: the largest shift of a channel's mean of y from the plain
    version's, over that channel's std — the bias BatchNorm would carry."""
    err, ref, tol, _ = bf16_check(got[0], want[0])
    yk, yp = got[0].double(), want[0].double()
    extra = {"y_mean_shift_over_std": float(
        ((yk - yp).mean((0, 1, 2)) / yp.std((0, 1, 2))).abs().max())}
    del yk, yp
    for name, g, w in (("s1", got[1], want[1]), ("s2", got[2], want[2])):
        e, r = _max_err(g, w)
        extra[f"{name}_err"], extra[f"{name}_ref"] = e, r
        require(e <= 1e-3 * r, f"conv_stats {name}: max abs err {e} > "
                               f"1e-3·{r}")
    return err, ref, tol, extra


def _row(layer, kernel, kfn, pfn, lfn, nbytes, ops, peak, check=bf16_check,
         library=None, per_step=0, per_step_ad=None, instance=None,
         same_bits=False):
    """``per_step``: launches of this row's kernel at this shape in one
    train step; ``per_step_ad`` the same with fused_train_deconv
    (default: ``per_step``); ``instance``: the template arguments of the
    kernel this row launches, for its ptxas figures; ``same_bits``: a
    second launch must give the same bits in every output."""
    return {"layer": layer, "kernel": kernel, "kfn": kfn, "pfn": pfn,
            "lfn": lfn, "bytes": nbytes, "ops": ops, "peak": peak,
            "check": check, "library": library, "per_step": per_step,
            "per_step_ad": per_step if per_step_ad is None else per_step_ad,
            "instance": instance, "same_bits": same_bits}


# demangled kernel name → its ptxas figures, filled after the build
PTXAS = {}


def _template_args(name):
    """A demangled kernel name with its template arguments as plain
    values: casts dropped (<(int)16, (bool)1> → <16, 1>), true/false as
    1/0."""
    name = re.sub(r"\((?:int|bool)\)", "", name)
    return re.sub(r"\bfalse\b", "0", re.sub(r"\btrue\b", "1", name))


def ptxas_of(kernel, instance):
    """Registers, spills and stack of ``<kernel>_kernel<instance>`` from
    the build's ptxas logs (None where the row names no instance);
    instance holds ints, bools and type names (``__nv_bfloat16``)."""
    if instance is None:
        return None
    args = ", ".join(str(int(v)) if isinstance(v, bool) else str(v)
                     for v in instance)
    name = f"{kernel}_kernel<{args}>"
    hit = [v for k, v in PTXAS.items() if _template_args(k).endswith(name)]
    return hit[0] if hit else {"missing": name}


def _cell(B, hw):
    """A row's cell: its batch and the forward's input size."""
    return f"b{B} {hw[0]}x{hw[1]}"


def _tagged(rows, B, hw):
    """Mark rows with their cell; rows outside the main cell name it in
    their layer and count in no train step."""
    cell = _cell(B, hw)
    for r in rows:
        r["cell"] = cell
        if cell != MAIN_CELL:
            r["layer"] += f" @{cell}"
            r["per_step"] = r["per_step_ad"] = 0
    return rows


def kernel_rows(dev, B=BATCH_MAIN, hw=HW):
    """One row per kernel-zone layer of the eval forward at batch ``B``
    and input ``hw`` (default: the main path's)."""
    import torch
    import torch.nn.functional as F

    from ubresnet_tpu_torch.ops import block, conv, deconv, pool

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    H, W = hw
    H2, W2, H4, W4 = H // 2, W // 2, H // 4, W // 4

    def act(*shape):
        return torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(bf)

    def weight(*shape, fan):
        return (torch.randn(*shape, generator=gen, device=dev)
                * (2.0 / fan) ** 0.5).to(bf).contiguous()

    def affine(c):
        g = 1.0 + 0.1 * torch.randn(c, generator=gen, device=dev)
        return g, 0.05 * torch.randn(c, generator=gen, device=dev)

    def cl(x):  # NHWC → channels-last NCHW view
        return x.permute(0, 3, 1, 2)

    def folded(w_hwio, g):  # (k, k, ci, co) + gain → OIHW bf16, channels last
        return (w_hwio.float() * g).permute(3, 2, 0, 1).to(bf).contiguous(
            memory_format=torch.channels_last)

    rows = []
    n2 = lambda t: t.numel() * t.element_size()  # noqa: E731

    # K4 stem pool: full resolution x 16 -> half
    x = act(B, H, W, 16)
    out_elems = B * H2 * W2 * 16
    rows.append(_row("stem pool", "maxpool3x3s2",
                     lambda x=x: pool.maxpool3x3s2(x),
                     lambda x=x: pool.maxpool3x3s2_plain(x),
                     lambda x=x: F.max_pool2d(cl(x), 3, 2, 1),
                     n2(x) + out_elems * 2, 8 * out_elems, F32_FLOPS,
                     check=exact_check, library="F.max_pool2d", per_step=1))

    # K2 blocks
    def block_row(name, hw, ca, cb, co, proj):
        a = act(B, *hw, ca)
        b = act(B, *hw, cb) if cb else None
        cin = ca + cb
        w1 = weight(3, 3, cin, co, fan=9 * co)
        w2 = weight(3, 3, co, co, fan=9 * co)
        (g1, b1), (g2, b2), (gb, bb) = affine(co), affine(co), affine(co)
        wb = weight(cin, co, fan=co) if proj else None
        args = (a, b, w1, g1, b1, w2, g2, b2, wb,
                gb if proj else None, bb if proj else None)
        lw1, lw2 = folded(w1, g1), folded(w2, g2)
        lb1, lb2 = b1.to(bf), b2.to(bf)
        lwb = folded(wb.view(1, 1, cin, co), gb) if proj else None
        lbb = bb.to(bf)

        def library(a=a, b=b):
            x = cl(a) if b is None else torch.cat([cl(a), cl(b)], 1)
            y = torch.relu(F.conv2d(x, lw1, lb1, padding=1))
            y = torch.relu(F.conv2d(y, lw2, lb2, padding=1))
            r = F.conv2d(x, lwb, lbb) if proj else x
            return torch.relu(y + r)

        pix = B * hw[0] * hw[1]
        macs = pix * (9 * cin * co + 9 * co * co + (cin * co if proj else 0))
        nbytes = n2(a) + (n2(b) if cb else 0) + pix * co * 2 + n2(w1) + n2(w2)
        rows.append(_row(name, "basic_block",
                         lambda: block.basic_block(*args),
                         lambda: block.basic_block_plain(*args),
                         library, nbytes, 2 * macs, BF16_TENSOR_FLOPS,
                         library="cuDNN block sequence"))

    block_row("enc1.res1", (H2, W2), 16, 0, 32, True)
    block_row("enc1.res2", (H2, W2), 32, 0, 32, False)

    def deconv_row(name, hw, ci, co):
        x = act(B, *hw, ci)
        w = weight(4, 4, ci, co, fan=16 * co)
        w_iohw = w.permute(2, 3, 0, 1).contiguous()
        out_pix = B * 4 * hw[0] * hw[1]
        rows.append(_row(name, "deconv2x",
                         lambda: deconv.deconv2x(x, w),
                         lambda: deconv.deconv2x_plain(x, w),
                         lambda: F.conv_transpose2d(cl(x), w_iohw, stride=2,
                                                    padding=1),
                         n2(x) + out_pix * co * 2 + n2(w),
                         2 * out_pix * 4 * ci * co, BF16_TENSOR_FLOPS,
                         library="F.conv_transpose2d", per_step_ad=1))

    deconv_row("dec2.deconv", (H4, W4), 64, 32)
    block_row("dec2.res.res1", (H2, W2), 32, 32, 32, True)
    block_row("dec2.res.res2", (H2, W2), 32, 0, 32, False)
    deconv_row("dec1.deconv", (H2, W2), 32, 16)
    block_row("dec1.res.res1", (H, W), 16, 16, 16, True)
    block_row("dec1.res.res2", (H, W), 16, 0, 16, False)

    # K1 head conv10 (BN + ReLU) and classifier conv11 (bias only)
    def conv_row(name, co, act_on):
        x = act(B, H, W, 16)
        w = weight(7, 7, 16, co, fan=49 * co)
        g, b = affine(co)
        if not act_on:
            g = torch.ones(co, device=dev)
        lw, lb = folded(w, g), b.to(bf)

        def library():
            y = F.conv2d(cl(x), lw, lb, padding=3)
            return torch.relu_(y) if act_on else y

        pix = B * H * W
        rows.append(_row(name, "conv_bn_act",
                         lambda: conv.conv_bn_act(x, w, g, b, act=act_on),
                         lambda: conv.conv_bn_act_plain(x, w, g, b,
                                                        act=act_on),
                         library, n2(x) + pix * co * 2 + n2(w),
                         2 * pix * 49 * 16 * co, BF16_TENSOR_FLOPS,
                         library="F.conv2d + folded affine",
                         per_step=int(not act_on),  # conv_ad's forward
                         instance=(16, co, 7)))

    conv_row("head conv10", 16, True)
    conv_row("classifier conv11", 3, False)
    return _tagged(rows, B, hw)


def train_kernel_rows(dev):
    """One row per distinct shape of the train zone at batch 16 and its
    own resolution: K5 forward (9), K1 input gradient (10), K6 weight
    gradient (10), K7 forward and backward at (16, 512, 512, 3)."""
    import torch
    import torch.nn.functional as F

    from ubresnet_tpu_torch.ops import conv, loss, train_conv

    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    B = BATCH_MAIN
    rows = []

    def act(*shape):
        return torch.relu(torch.randn(*shape, generator=gen, device=dev)).to(bf)

    def grad(*shape):
        return (0.01 * torch.randn(*shape, generator=gen, device=dev)).to(bf)

    def weight(k, ci, co):
        return (torch.randn(k, k, ci, co, generator=gen, device=dev)
                * (2.0 / (k * k * co)) ** 0.5).to(bf).contiguous()

    def cl(x):
        return x.permute(0, 3, 1, 2)

    def oihw(w):
        return w.permute(3, 2, 0, 1).contiguous()

    for (ci, co, k), hw, count in TRAIN_ZONE:
        x = act(B, hw, hw, ci)
        w = weight(k, ci, co)
        bias = 0.05 * torch.randn(co, generator=gen, device=dev)
        pix = B * hw * hw
        macs = pix * k * k * ci * co
        lw, lb = oihw(w), bias.to(bf)

        def library(x=x, lw=lw, lb=lb, k=k):
            y = F.conv2d(cl(x), lw, lb, padding=k // 2).float()
            return y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))

        rows.append(_row(
            f"K5 {ci}->{co} k{k} @{hw}", "conv_stats",
            lambda x=x, w=w, b=bias: train_conv.conv_stats(x, w, b),
            lambda x=x, w=w, b=bias: train_conv.conv_stats_plain(x, w, b),
            library, pix * (ci + co) * 2 + w.numel() * 2 + co * 8,
            2 * macs, BF16_TENSOR_FLOPS, check=stats_check,
            library="F.conv2d + two channel sums", per_step=count,
            instance=(ci, co, k), same_bits=True))

    for (ci, co, k), hw, count in TRAIN_ZONE + [CLASSIFIER]:
        dy = grad(B, hw, hw, co)
        w = weight(k, ci, co)
        wt = w.flip((0, 1)).transpose(2, 3)
        ones = torch.ones(ci, device=dev)
        zeros = torch.zeros(ci, device=dev)
        pix = B * hw * hw
        macs = pix * k * k * ci * co
        lw = oihw(w)
        rows.append(_row(
            f"K1 dx {ci}<-{co} k{k} @{hw}", "conv_bn_act",
            lambda dy=dy, w=w: conv.conv_input_grad(dy, w),
            lambda dy=dy, wt=wt, o=ones, z=zeros: conv.conv_bn_act_plain(
                dy, wt, o, z, act=False),
            lambda dy=dy, lw=lw, ci=ci, hw=hw, k=k:
                torch.nn.grad.conv2d_input((B, ci, hw, hw), lw, cl(dy),
                                           padding=k // 2),
            pix * (ci + co) * 2 + w.numel() * 2, 2 * macs, BF16_TENSOR_FLOPS,
            library="torch.nn.grad.conv2d_input", per_step=count,
            instance=(-(-co // 4) * 4, ci, k)))

        x = act(B, hw, hw, ci)
        rows.append(_row(
            f"K6 dW {ci}->{co} k{k} @{hw}", "conv_dw",
            lambda x=x, dy=dy, k=k: conv.conv_dw(x, dy, k),
            lambda x=x, dy=dy, k=k: conv.conv_dw_plain(x, dy, k),
            lambda x=x, dy=dy, ci=ci, co=co, k=k:
                torch.nn.grad.conv2d_weight(cl(x), (co, ci, k, k), cl(dy),
                                            padding=k // 2),
            pix * (ci + co) * 2 + k * k * ci * co * 4, 2 * macs,
            BF16_TENSOR_FLOPS, check=f32_check(1e-3),
            library="torch.nn.grad.conv2d_weight", per_step=count,
            instance=(ci, co, k)))

    n = B * 512 * 512
    logits = 3 * torch.randn(B, 512, 512, 3, generator=gen, device=dev)
    labels = torch.randint(0, 3, (B, 512, 512), generator=gen, device=dev,
                           dtype=torch.int32)
    weights = 2 * torch.rand(B, 512, 512, generator=gen, device=dev)
    g = torch.tensor(1.0, device=dev)
    lt = logits.permute(0, 3, 1, 2)
    lab64 = labels.long()

    def library_fwd(lt=lt):
        return (F.cross_entropy(lt, lab64, reduction="none") * weights).mean()

    lreq = lt.detach().clone().requires_grad_(True)
    lib_loss = library_fwd(lreq)
    rows.append(_row(
        "K7 loss forward (16,512,512,3)", "weighted_nll",
        lambda: loss.weighted_nll_fwd(logits, labels, weights),
        lambda: loss.weighted_nll_fwd_plain(logits, labels, weights),
        library_fwd, n * (12 + 4 + 4) + 4, 20 * n, F32_FLOPS,
        check=f32_check(1e-5),
        library="F.cross_entropy(reduction='none')·w, mean", per_step=1))
    rows.append(_row(
        "K7 loss backward (16,512,512,3)", "weighted_nll_bwd",
        lambda: loss.weighted_nll_bwd(logits, labels, weights, g),
        lambda: loss.weighted_nll_bwd_plain(logits, labels, weights, g),
        lambda: torch.autograd.grad(lib_loss, lreq, retain_graph=True),
        n * (12 + 4 + 4 + 12), 30 * n, F32_FLOPS, check=f32_check(1e-5),
        library="autograd backward of the forward's sequence", per_step=1))
    return rows


def ad_check(got, want):
    """deconv2x_ad forward + backward: y and dx as bf16 outputs, the
    bf16 dW (rounded to the kernel's dtype, as in JAX) against the f32
    plain dW — each within one bf16 step, ≤ 1e-2·max|plain|."""
    err, ref, tol, _ = bf16_check(got[0], want[0].to(got[0].dtype))
    extra = {}
    for name, g, w in (("dx", got[1], want[1]), ("dw", got[2], want[2])):
        e, r = _max_err(g, w)
        extra[f"{name}_err"], extra[f"{name}_ref"] = e, r
        require(e <= 1e-2 * r, f"deconv2x_ad {name}: max abs err {e} > "
                               f"1e-2·{r}")
    return err, ref, tol, extra


def deconv_dw_f64(x, dy):
    """The deconv's dW in float64, tap by tap: dW[kr, kc] = xᵀ · dy at
    rows 2i + kr - 1, columns 2j + kc - 1 (zero outside dy), one matmul
    per tap over every pixel."""
    import torch
    import torch.nn.functional as F

    h, w, ci, co = x.shape[1], x.shape[2], x.shape[3], dy.shape[3]
    xm = x.double().reshape(-1, ci)
    dp = F.pad(dy.double(), (0, 0, 1, 1, 1, 1))
    return torch.stack([
        xm.T @ dp[:, kr:kr + 2 * h:2, kc:kc + 2 * w:2].reshape(-1, co)
        for kr in range(4) for kc in range(4)]).reshape(4, 4, ci, co)


def dw_check(x, dy):
    """K9: f32 dW within 1e-3·max|plain| (sums over 1-4 M pixels in
    another order). Also reported, not gated: the kernel's and the plain
    f32 version's largest distance from the float64 dW, against that
    dW's largest magnitude — the drift a long chain of tensor-core adds
    would show."""
    f32 = f32_check(1e-3)

    def check(got, want):
        err, ref, tol, extra = f32(got, want)
        exact = deconv_dw_f64(x, dy)
        return err, ref, tol, {
            **extra, "f64_max_abs": float(exact.abs().max()),
            "f64_max_abs_err": float((got.double() - exact).abs().max()),
            "plain_f64_max_abs_err": float(
                (want.double() - exact).abs().max())}
    return check


def deconv_ad_rows(dev):
    """The decoder upsamples' backward at batch 16 and their own
    resolution (dec2: x 128² x 64 → 256² x 32, dec1: 256² x 32 → 512² x
    16): K8 dx and K9 dW, one launch each per deconv-AD step, and
    deconv2x_ad forward + backward (K3, K8, K9) against
    F.conv_transpose2d's autograd — its plain version in f32, its
    library call in bf16 (cuDNN)."""
    import torch
    import torch.nn.functional as F

    from ubresnet_tpu_torch.ops import deconv

    gen = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    B = BATCH_MAIN
    rows = []
    n2 = lambda t: t.numel() * t.element_size()  # noqa: E731

    for name, hw, ci, co in (("dec2", 128, 64, 32), ("dec1", 256, 32, 16)):
        x = torch.relu(torch.randn(B, hw, hw, ci, generator=gen,
                                   device=dev)).to(bf)
        dy = (0.01 * torch.randn(B, 2 * hw, 2 * hw, co, generator=gen,
                                 device=dev)).to(bf)
        w = (torch.randn(4, 4, ci, co, generator=gen, device=dev)
             * (2.0 / (16 * co)) ** 0.5).to(bf).contiguous()
        w_oihw = w.permute(2, 3, 0, 1).contiguous()  # (ci, co, 4, 4)
        macs = B * hw * hw * 16 * ci * co

        def cl(t):
            return t.permute(0, 3, 1, 2)

        rows.append(_row(
            f"K8 dx {name} {ci}<-{co} @{2 * hw}", "conv_s2k4",
            lambda dy=dy, w=w: deconv.conv_s2k4(dy, w),
            lambda dy=dy, w=w: deconv.conv_s2k4_plain(dy, w),
            lambda dy=dy, wo=w_oihw: F.conv2d(cl(dy), wo, stride=2,
                                              padding=1),
            n2(dy) + n2(x) + n2(w), 2 * macs, BF16_TENSOR_FLOPS,
            library="F.conv2d stride 2", per_step_ad=1, instance=(ci, co),
            same_bits=True))
        rows.append(_row(
            f"K9 dW {name} {ci}->{co} @{hw}", "deconv_dw",
            lambda x=x, dy=dy: deconv.deconv_dw(x, dy),
            lambda x=x, dy=dy: deconv.deconv_dw_plain(x, dy),
            lambda x=x, dy=dy, ci=ci, co=co: torch.nn.grad.conv2d_weight(
                cl(dy), (ci, co, 4, 4), cl(x), stride=2, padding=1),
            n2(x) + n2(dy) + 16 * ci * co * 4, 2 * macs, BF16_TENSOR_FLOPS,
            check=dw_check(x, dy), library="torch.nn.grad.conv2d_weight",
            per_step_ad=1, instance=(ci, co), same_bits=True))

        def ad(x=x, w=w, dy=dy):
            xr, wr = x.detach().requires_grad_(), w.detach().requires_grad_()
            y = deconv.deconv2x_ad(xr, wr)
            return (y.detach(), *torch.autograd.grad(y, (xr, wr), dy))

        def ad_plain(x=x, w=w, dy=dy, dtype=torch.float32):
            xr = x.detach().to(dtype).requires_grad_()
            wr = w.detach().permute(2, 3, 0, 1).to(dtype).requires_grad_()
            y = F.conv_transpose2d(cl(xr), wr, stride=2, padding=1)
            dx, dw = torch.autograd.grad(y, (xr, wr), cl(dy).to(dtype))
            return (y.permute(0, 2, 3, 1).detach(), dx,
                    dw.permute(2, 3, 0, 1))

        rows.append(_row(
            f"deconv2x_ad fwd+bwd {name} {ci}->{co} @{hw}", "deconv2x_ad",
            ad, ad_plain, lambda f=ad_plain: f(dtype=bf),
            3 * (n2(x) + n2(dy)) + 2 * n2(w) + 16 * ci * co * 4,
            3 * 2 * macs, BF16_TENSOR_FLOPS, check=ad_check,
            library="F.conv_transpose2d + autograd (cuDNN bf16)"))
    return rows


def s8_check(exact):
    """int8 rows: the kernel's and the plain version's float32 outputs
    (``exact()`` runs both; with g = 1, b = 0 for the conv and the
    deconv that output is the s32 accumulator itself) must be
    bit-identical — exact integer sums, the same f32 epilogue steps —
    and the bf16 outputs of the main path within one bf16 step."""
    def check(got, want):
        import torch

        err, ref, tol, _ = bf16_check(got, want)
        k32, p32 = exact()
        torch.cuda.synchronize()
        e32, _ = _max_err(k32, p32)
        require(torch.equal(k32, p32), f"int8 kernel's f32 output differs "
                                       f"from its plain version's by {e32}")
        return err, ref, tol, {"f32_exact": True, "f32_max_abs_err": e32}
    return check


def int8_kernel_rows(dev, eval_rows, B=BATCH_MAIN, hw=HW):
    """One row per int8-zone layer of the int8 forward at batch ``B``
    and input ``hw`` (default: the main path's): K1-s8 (head conv10),
    K2-s8 (the six blocks, two
    dual), K3-s8 (dec2, dec1 upsamples). Inputs are int8 on the grid a
    calibrated model gives (post-ReLU activations, 0..127), weights
    int8, gains as the model folds them. No single PyTorch call computes
    an int8 conv, so library_ms is null; the bf16 kernel's and the cuDNN
    bf16 sequence's times of the same layer (``eval_rows``, this run)
    stand beside it for scale."""
    import torch

    from ubresnet_tpu_torch.ops import block, conv, deconv

    gen = torch.Generator(device=dev).manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32
    H, W = hw
    H2, W2, H4, W4 = H // 2, W // 2, H // 4, W // 4
    cell = _cell(B, hw)
    bf16_rows = {r["layer"]: r for r in eval_rows if r["cell"] == cell}
    tag = "" if cell == MAIN_CELL else f" @{cell}"
    rows = []
    n2 = lambda t: t.numel() * t.element_size()  # noqa: E731

    def act(*shape):  # post-ReLU int8 activations
        return torch.randint(0, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def weight(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def gain(c, scale):
        g = torch.rand(c, generator=gen, device=dev) * scale
        return g, torch.randn(c, generator=gen, device=dev)

    def add(layer, kernel, kfn, pfn, exact, nbytes, macs, instance=None):
        r = _row(layer, kernel, kfn, pfn, None, nbytes, 2 * macs,
                 INT8_TENSOR_OPS, check=s8_check(exact), instance=instance)
        r["bf16"] = bf16_rows[layer + tag]
        rows.append(r)

    # K1-s8 head conv10: full resolution, 16 -> 16, 7x7
    x, w = act(B, H, W, 16), weight(7, 7, 16, 16)
    g, b = gain(16, 2e-5)
    one, zero = torch.ones(16, device=dev), torch.zeros(16, device=dev)
    pix = B * H * W
    add("head conv10", "conv_bn_act_s8",
        lambda: conv.conv_bn_act_s8(x, w, g, b),
        lambda: conv.conv_bn_act_s8_plain(x, w, g, b),
        lambda: (conv.conv_bn_act_s8(x, w, one, zero, act=False,
                                     out_dtype=f32),
                 conv.conv_bn_act_s8_plain(x, w, one, zero, act=False,
                                           out_dtype=f32)),
        n2(x) + pix * 16 * 2 + n2(w), pix * 49 * 16 * 16,
        instance=(16, 16, 7, "__nv_bfloat16"))

    def block_row(name, hw, ca, cb, co, proj):
        a = act(B, *hw, ca)
        bq = act(B, *hw, cb) if cb else None
        cin = ca + cb
        # conv1's s32 sum has std ≈ 5370·sqrt(9·cin) on these inputs:
        # this g1 spreads m over the int8 grid (std ≈ 30, tail at 127)
        g1, b1 = gain(co, 0.011 / (9 * cin) ** 0.5)
        g2, b2 = gain(co, 1e-4)
        if proj:
            gb, bb = gain(co, 1e-4)
        else:
            gb, bb = torch.full((co,), 0.05, device=dev), torch.zeros(
                co, device=dev)
        args = (a, bq, weight(3, 3, cin, co), g1, b1, weight(3, 3, co, co),
                g2, b2, weight(cin, co) if proj else None, gb, bb)
        p = B * hw[0] * hw[1]
        macs = p * (9 * cin * co + 9 * co * co + (cin * co if proj else 0))
        nbytes = (p * cin + p * co * 2 + n2(args[2]) + n2(args[5])
                  + (n2(args[8]) if proj else 0))
        add(name, "basic_block_s8",
            lambda: block.basic_block_s8(*args),
            lambda: block.basic_block_s8_plain(*args),
            lambda: (block.basic_block_s8(*args, out_dtype=f32),
                     block.basic_block_s8_plain(*args, out_dtype=f32)),
            nbytes, macs, instance=(ca, cb, co, proj, "__nv_bfloat16"))

    def deconv_row(name, hw, ci, co):
        xq, wq = act(B, *hw, ci), weight(4, 4, ci, co)
        gq, _ = gain(co, 1e-4)
        ones = torch.ones(co, device=dev)
        p = B * 4 * hw[0] * hw[1]
        add(name, "deconv2x_s8",
            lambda: deconv.deconv2x_s8(xq, wq, gq),
            lambda: deconv.deconv2x_s8_plain(xq, wq, gq),
            lambda: (deconv.deconv2x_s8(xq, wq, ones, out_dtype=f32),
                     deconv.deconv2x_s8_plain(xq, wq, ones, f32)),
            n2(xq) + p * co * 2 + n2(wq), p * 4 * ci * co,
            instance=(ci, co, "__nv_bfloat16"))

    block_row("enc1.res1", (H2, W2), 16, 0, 32, True)
    block_row("enc1.res2", (H2, W2), 32, 0, 32, False)
    deconv_row("dec2.deconv", (H4, W4), 64, 32)
    block_row("dec2.res.res1", (H2, W2), 32, 32, 32, True)
    block_row("dec2.res.res2", (H2, W2), 32, 0, 32, False)
    deconv_row("dec1.deconv", (H2, W2), 32, 16)
    block_row("dec1.res.res1", (H, W), 16, 16, 16, True)
    block_row("dec1.res.res2", (H, W), 16, 0, 16, False)
    return _tagged(rows, B, hw)


def _ratios(r):
    """pct_of_bound = bound_ms / ms; vs_library = ms / library_ms (None
    without a library call): the same call's measurements."""
    lib = r["library_ms"]
    return {"pct_of_bound": r["bound_ms"] / r["ms"],
            "vs_library": None if lib is None else r["ms"] / lib}


def check_kernels(rows):
    import torch

    results = []
    for r in rows:
        got = r["kfn"]()
        want = r["pfn"]()
        torch.cuda.synchronize()
        err, ref, tol, extra = r["check"](got, want)
        if r["same_bits"]:
            again = r["kfn"]()
            torch.cuda.synchronize()
            pairs = zip(got, again) if isinstance(got, tuple) else [(got,
                                                                      again)]
            require(all(torch.equal(a, b) for a, b in pairs),
                    f"{r['layer']}: a second launch gave other bits")
            extra = {**extra, "same_bits": True}
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / r["peak"] * 1e3
        if "bf16" in r:  # int8 rows: the same layer's bf16 times
            extra = {**extra, "bf16_kernel_ms": r["bf16"]["ms"],
                     "cudnn_bf16_ms": r["bf16"]["library_ms"],
                     "cudnn_bf16": r["bf16"]["library"]}
        row = {
            "phase": "kernel", "layer": r["layer"], "kernel": r["kernel"],
            "cell": r.get("cell", MAIN_CELL),
            "shape": list((got[0] if isinstance(got, tuple) else got).shape),
            "max_abs_err": err, "max_abs_ref": ref, "tolerance": tol,
            **extra, "ms": time_ms(r["kfn"]), "plain_ms": time_ms(r["pfn"]),
            "library_ms": None if r["lfn"] is None else time_ms(r["lfn"]),
            "library": r["library"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": r["bytes"], "operations": r["ops"], "bytes_ms": t_bytes,
            "ops_ms": t_ops, "per_step": r["per_step"],
            "per_step_ad": r["per_step_ad"],
            "ptxas": ptxas_of(r["kernel"], r["instance"]),
        }
        row.update(_ratios(row))
        emit(row)
        require(err <= tol, f"{r['layer']}: kernel disagrees with its plain "
                            f"version: max abs err {err} > {tol}")
        results.append(row)
    return results


def train_zone_per_step(rows, key="per_step", want=LAUNCHES_PER_TRAIN_STEP,
                        phase="train_zone_per_step"):
    """Each kernel's share of one b16 train step: the rows' times
    weighted by their launches per step (``key``: their multiplicity on
    the default train path, or with fused_train_deconv), beside the
    same sums of bound, plain and library times."""
    out = {}
    for r in rows:
        n = r.get(key, 0)
        if not n:
            continue
        k = out.setdefault(r["kernel"], {"launches": 0, "ms": 0.0,
                                         "plain_ms": 0.0, "library_ms": 0.0,
                                         "bound_ms": 0.0})
        k["launches"] += n
        for field in ("ms", "plain_ms", "library_ms", "bound_ms"):
            k[field] += n * r[field]
    require({k: v["launches"] for k, v in out.items()} == want,
            f"per-step rows {out} != {want}")
    return {"phase": phase, "kernels": out,
            "ms": sum(v["ms"] for v in out.values()),
            "bound_ms": sum(v["bound_ms"] for v in out.values())}


def _row_sums(mine):
    """A kernel's times summed over its rows ``mine``: ms, plain, bound
    (and what bounds the sum), library (None if a row has none)."""
    t_bytes = sum(r["bytes_ms"] for r in mine)
    t_ops = sum(r["ops_ms"] for r in mine)
    lib = [r["library_ms"] for r in mine]
    out = {"ms": sum(r["ms"] for r in mine),
           "plain_ms": sum(r["plain_ms"] for r in mine),
           "bound_ms": sum(r["bound_ms"] for r in mine),
           "bound_by": "operations" if t_ops > t_bytes else "bytes",
           "library_ms": None if None in lib else sum(lib)}
    out.update(_ratios(out))
    return out


def kernels_line(rows, launches_by_path):
    """One entry per kernel: its launches on every path; its times
    summed over its rows at the main cell (b16 512x512), and under
    ``at_shapes`` the same sums at each other cell its rows ran at
    (the wholeview shapes); the largest error over all its rows."""
    out = []
    for name, (src, replaces, kernels, _) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] in kernels]
        main = [r for r in mine if r["cell"] == MAIN_CELL]
        by_path = {path: sum(counts[k] for k in kernels)
                   for path, counts in launches_by_path.items()}
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": max(r["max_abs_err"] for r in mine),
                 **_row_sums(main), "layers": [r["layer"] for r in main]}
        cells = sorted({r["cell"] for r in mine} - {MAIN_CELL})
        if cells:
            entry["at_shapes"] = {c: _row_sums([r for r in mine
                                                if r["cell"] == c])
                                  for c in cells}
        out.append(entry)
    return {"kernels": out}


def stage_breakdown(model, x, reps=5):
    """Device ms per forward of each top-level stage, from CUDA events
    recorded by forward hooks; ``stem pool`` is the gap between the stem
    conv and enc1, ``rest`` the forward's remainder (log-softmax)."""
    import torch

    stages = [("stem conv", model.conv1)]
    stages += [(f"enc{i + 1}", m) for i, m in enumerate(model.enc)]
    depth = len(model.dec)
    stages += [(f"dec{depth - i}", m) for i, m in enumerate(model.dec)]
    stages += [("head conv10", model.conv10), ("classifier conv11", model.conv11)]
    marks = []

    def mark(tag):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((tag, ev))

    hooks = []
    for name, mod in stages:
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a, n=name: mark((n, 0))))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, n=name: mark((n, 1))))
    ms = {name: 0.0 for name, _ in stages}
    ms["stem pool"] = ms["rest"] = total = 0.0
    with torch.inference_mode():
        model(x)  # warm-up
        for _ in range(reps):
            marks.clear()
            mark(("forward", 0))
            model(x)
            mark(("forward", 1))
            torch.cuda.synchronize()
            ev = dict(marks)
            for name, _ in stages:
                ms[name] += ev[(name, 0)].elapsed_time(ev[(name, 1)])
            ms["stem pool"] += ev[("stem conv", 1)].elapsed_time(ev[("enc1", 0)])
            ms["rest"] += ev[("classifier conv11", 1)].elapsed_time(
                ev[("forward", 1)])
            total += ev[("forward", 0)].elapsed_time(ev[("forward", 1)])
    for h in hooks:
        h.remove()
    out = {k: v / reps for k, v in ms.items()}
    out["total"] = total / reps
    return out


def main_path(dev, card, work):
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.infer_precropped import main as cli
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy.weights import (
        random_state_dict,
        save_reference_checkpoint,
    )
    from ubresnet_tpu_torch.models import get_model

    src, out, tar = (os.path.join(work, f) for f in
                     ("crops.uevt", "scores.uevt", "weights.tar"))
    t0 = time.time()
    make_synthetic_file(src, n_events=EVENTS, hw=HW, seed=0)
    sd = random_state_dict(seed=0)
    save_reference_checkpoint(sd, tar)
    setup_s = time.time() - t0

    def run_cli():
        printed = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(printed):
            rc = cli(["-i", src, "-o", out, "-c", tar, "-b", str(BATCH_MAIN),
                      "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        require(rc == 0, f"CLI returned {rc}")
        return wall, json.loads(printed.getvalue().strip().splitlines()[-1])

    ops.reset_launch_counts()
    wall, timing = run_cli()
    launches = ops.launch_counts()
    batches = -(-EVENTS // BATCH_MAIN)
    want = {k: LAUNCHES_PER_BATCH.get(k, 0) * batches for k in launches}
    require(launches == want, f"launch counts {launches} != {want}")

    worst = _check_scores(out, EVENTS, "uburn_plane2", HW)

    # the same job again in this process: model build, first cuDNN calls
    # and pinned buffers no longer first-time costs
    wall_warm, timing_warm = run_cli()

    # forward-only rate at batch 16, and argmax agreement on that batch
    inp = EventFileReader(src)
    crops = np.stack([inp.read_entry(i, producers=["wire"])["wire"][0].pixels
                      for i in range(BATCH_MAIN)])[..., None]
    x = torch.from_numpy(crops).to(dev)
    model = get_model("uresnet", sd, device=dev)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x), budget_ms=1000.0)
        stages = stage_breakdown(model, x)
        profile = forward_profile(lambda: model(x), fwd_ms)
        fused = model(x).argmax(-1)
        plain = get_model("uresnet", sd, policy=Policy.f32(), device=dev)
        ref = plain(x).argmax(-1)
    agree = float((fused == ref).float().mean())
    result = {
        "phase": "main_path", "card": card, "events": EVENTS,
        "batch": BATCH_MAIN, "hw": list(HW), "setup_s": setup_s,
        "cli_wall_s": wall, "crops_per_s_file_to_file": EVENTS / wall,
        "cli_wall_s_warm": wall_warm,
        "crops_per_s_file_to_file_warm": EVENTS / wall_warm,
        "forward_ms_b16": fwd_ms,
        "crops_per_s_forward_b16": BATCH_MAIN / fwd_ms * 1e3,
        "stage_ms_b16": stages, "profile_b16": profile,
        "argmax_agreement_b16_vs_f32": agree, "score_sum_max_dev": worst,
        "launches": launches, "timing": timing, "timing_warm": timing_warm,
        "crops_per_s_runner": EVENTS / timing["total"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    emit(result)
    require(agree >= 0.99, f"kernel path vs f32 argmax agreement {agree}")
    return launches


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper the eval model calls to its plain
    PyTorch version (on the card too): the model's plain path, for
    holding the kernel path against it."""
    from ubresnet_tpu_torch.ops import block, conv, deconv, pool

    swaps = [(conv, "conv_bn_act", conv.conv_bn_act_plain),
             (conv, "conv_bn_act_s8", conv.conv_bn_act_s8_plain),
             (block, "basic_block", block.basic_block_plain),
             (block, "basic_block_s8", block.basic_block_s8_plain),
             (deconv, "deconv2x", deconv.deconv2x_plain),
             (deconv, "deconv2x_s8", deconv.deconv2x_s8_plain),
             (pool, "maxpool3x3s2", pool.maxpool3x3s2_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def int8_path(dev, card, work):
    """int8 precropped deploy: the deploy smoke's 64 crops and weights
    through the CLI with --int8 (calibrated on the first 32 crops, -b
    16, cuda): 11 launches per batch, 9 of them int8; score sums. Then on
    the first 16 crops with the CLI's calibration: the int8 kernel path
    against the int8 plain path (same scales; gate: argmax ≥ 0.99), the
    int8 and bf16 forward ms at b16, the int8 stage breakdown, and —
    reported, not gated (random weights) — mean|Δp| and argmax agreement
    against the f32 path for abs-max and percentile-99.9 scales."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.infer_precropped import main as cli
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy import PrecroppedRunner
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.quant import calibrate

    src, out, tar = (os.path.join(work, f) for f in
                     ("crops.uevt", "scores_int8.uevt", "weights.tar"))
    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = cli(["-i", src, "-o", out, "-c", tar, "-b", str(BATCH_MAIN),
                  "--int8", "--int8-calib", str(INT8_CALIB), "-v",
                  "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    require(rc == 0, f"int8 CLI returned {rc}")
    lines = printed.getvalue().strip().splitlines()
    require(f"int8: calibrated on {INT8_CALIB} images" in lines,
            f"int8 CLI did not calibrate on {INT8_CALIB} images: {lines[:3]}")
    timing = json.loads(lines[-1])
    batches = -(-EVENTS // BATCH_MAIN)
    want = {k: LAUNCHES_PER_BATCH_INT8.get(k, 0) * batches for k in launches}
    require(launches == want, f"int8 launch counts {launches} != {want}")

    worst = _check_scores(out, EVENTS, "uburn_plane2", HW)

    sd, _ = load_reference_checkpoint(tar)
    inp = EventFileReader(src)
    x = torch.from_numpy(np.stack(
        [inp.read_entry(i, producers=["wire"])["wire"][0].pixels
         for i in range(BATCH_MAIN)])[..., None]).to(dev)
    model = get_model("uresnet", sd, policy=Policy.int8(), device=dev)
    runner = PrecroppedRunner(model, batch_size=BATCH_MAIN)
    t0 = time.time()
    runner.calibrate_from(src, n_images=INT8_CALIB)
    torch.cuda.synchronize()
    calib_s = time.time() - t0
    bf16 = get_model("uresnet", sd, device=dev)
    with torch.inference_mode():
        int8_ms = time_ms(lambda: model(x), budget_ms=1000.0)
        bf16_ms = time_ms(lambda: bf16(x), budget_ms=1000.0)
        stages = stage_breakdown(model, x)
        profile_int8 = forward_profile(lambda: model(x), int8_ms)
        lp_kernel = model(x)
        with plain_kernels():
            lp_plain = model(x)
        lp_f32 = get_model("uresnet", sd, policy=Policy.f32(), device=dev)(x)
    p_f32 = lp_f32.exp()
    agree_plain = float((lp_kernel.argmax(-1) == lp_plain.argmax(-1))
                        .float().mean())

    def vs_f32(lp):
        return {"mean_abs_dp": float((lp.exp() - p_f32).abs().mean()),
                "argmax_agreement": float((lp.argmax(-1) == lp_f32.argmax(-1))
                                          .float().mean())}

    accuracy = {"absmax": vs_f32(lp_kernel)}
    crops = np.stack([inp.read_entry(i, producers=["wire"])["wire"][0].pixels
                      for i in range(INT8_CALIB)])[..., None]
    model.set_quant_scales(calibrate(model, [crops], percentile=99.9))
    with torch.inference_mode():
        accuracy["percentile_99.9"] = vs_f32(model(x))
    result = {
        "phase": "int8", "card": card, "events": EVENTS, "batch": BATCH_MAIN,
        "hw": list(HW), "calib_images": INT8_CALIB, "cli_wall_s": wall,
        "crops_per_s_file_to_file": EVENTS / wall, "timing": timing,
        "calibrate_s_api": calib_s, "launches": launches,
        "score_sum_max_dev": worst,
        "forward_ms_b16_int8": int8_ms, "forward_ms_b16_bf16": bf16_ms,
        "int8_over_bf16_forward": int8_ms / bf16_ms,
        "crops_per_s_forward_b16_int8": BATCH_MAIN / int8_ms * 1e3,
        "stage_ms_b16_int8": stages, "profile_b16_int8": profile_int8,
        "argmax_agreement_kernel_vs_plain_int8": agree_plain,
        "max_abs_dlogprob_kernel_vs_plain_int8": float(
            (lp_kernel - lp_plain).abs().max()),
        "vs_f32_not_gated": accuracy,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    emit(result)
    require(agree_plain >= 0.99, f"int8 kernel path vs int8 plain path "
                                 f"argmax agreement {agree_plain}")
    return launches


def _check_scores(path, n, producer, hw):
    """Every event of ``path`` carries 3 finite ``producer`` score
    images of ``hw`` summing to 1 ± 1e-2; returns the largest deviation
    of a sum."""
    import numpy as np

    from ubresnet_tpu_torch.data.uevt import EventFileReader

    reader = EventFileReader(path)
    require(len(reader) == n, f"{path}: {len(reader)} events written")
    worst = 0.0
    for i in range(n):
        imgs = reader.read_entry(i).get(producer, [])
        require(len(imgs) == 3, f"event {i}: {len(imgs)} {producer} images")
        s = np.stack([im.pixels for im in imgs], -1).astype(np.float32)
        require(s.shape == tuple(hw) + (3,) and np.isfinite(s).all(),
                f"event {i}: bad scores {s.shape}")
        worst = max(worst, float(np.abs(s.sum(-1) - 1.0).max()))
    require(worst <= 1e-2, f"{path}: score sums off by {worst}")
    return worst


def _times(table, n):
    return {k: v * n for k, v in table.items()}


def _merge(*counts):
    return {k: sum(c.get(k, 0) for c in counts) for k in counts[0]}


def wholeview_path(dev, card, work):
    """Whole-plane deploy: WV_EVENTS synthetic 1008x3456 planes (seed 0)
    through the port's wholeview CLI (--device cuda) with the deploy
    smoke's weights: spatial (the default; first, warm, then with
    --f16-scores), --stitched, and --int8 --int8-calib 2 (spatial).
    Gates: 3 ubsnet_plane2 images per event summing to 1 ± 1e-2; exact
    launch counts (per plane 11 spatial, 11 per 10-crop chunk stitched,
    the int8 table under --int8); on one plane the kernel path against the
    plain f32 path (TF32 off), spatial and stitched, and the int8 kernel
    path against the int8 plain path on the same scales: argmax ≥ 0.99.
    Reported: planes/s, the timing dicts, forward ms per plane (spatial
    b1 1024x3456, stitched one b10 512x832 chunk, int8 spatial), the
    spatial forward's stages and profile, peak memory. Returns the
    launches of the CLI runs."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.infer_wholeview import main as cli
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy import WholeViewRunner
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.tiling import extract_tiles

    src, out, tar = (os.path.join(work, f) for f in
                     ("planes.uevt", "plane_scores.uevt", "weights.tar"))
    t0 = time.time()
    make_synthetic_file(src, n_events=WV_EVENTS, seed=0, wholeview=True)
    setup_s = time.time() - t0
    sd, _ = load_reference_checkpoint(tar)
    bf16 = get_model("uresnet", sd, device=dev)
    stitched = WholeViewRunner(bf16)  # the CLI's default tiles and chunk
    grid = stitched._grid(WV_HW)
    chunks = -(-len(grid) // stitched.crop_batch)

    def run_cli(*extra):
        printed = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(printed):
            rc = cli(["-i", src, "-o", out, "-c", tar, "--device", "cuda",
                      *extra])
        torch.cuda.synchronize()
        wall = time.time() - t0
        require(rc == 0, f"wholeview CLI {extra} returned {rc}")
        launches = ops.launch_counts()
        sums = _check_scores(out, WV_EVENTS, "ubsnet_plane2", WV_HW)
        return {"cli_wall_s": wall, "planes_per_s_file_to_file":
                WV_EVENTS / wall, "launches": launches,
                "timing": json.loads(printed.getvalue().splitlines()[-1]),
                "score_sum_max_dev": sums,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}

    runs = {"spatial": run_cli(), "spatial_warm": run_cli(),
            "spatial_f16_scores": run_cli("--f16-scores"),
            "stitched": run_cli("--stitched"),
            "int8": run_cli("--int8", "--int8-calib", str(WV_CALIB))}
    want = {"spatial": _times(LAUNCHES_PER_BATCH, WV_EVENTS),
            "spatial_warm": _times(LAUNCHES_PER_BATCH, WV_EVENTS),
            "spatial_f16_scores": _times(LAUNCHES_PER_BATCH, WV_EVENTS),
            "stitched": _times(LAUNCHES_PER_BATCH, WV_EVENTS * chunks),
            "int8": _times(LAUNCHES_PER_BATCH_INT8, WV_EVENTS)}
    for name, run in runs.items():
        got = run["launches"]
        exp = {k: want[name].get(k, 0) for k in got}
        require(got == exp, f"wholeview {name} launch counts {got} != {exp}")

    # one plane: kernel paths against plain paths
    plane = EventFileReader(src).read_entry(0, producers=["wire"])[
        "wire"][0].pixels
    f32 = get_model("uresnet", sd, policy=Policy.f32(), device=dev)
    agree = {}
    for mode, spatial in (("spatial", True), ("stitched", False)):
        k = WholeViewRunner(bf16, spatial=spatial).score_image(plane)
        p = WholeViewRunner(f32, spatial=spatial).score_image(plane)
        agree[mode] = float((k.argmax(-1) == p.argmax(-1)).mean())
    del f32
    q = get_model("uresnet", sd, policy=Policy.int8(), device=dev)
    qr = WholeViewRunner(q, spatial=True)
    n_tiles = qr.calibrate_from(src, n_images=WV_CALIB)
    kq = qr.score_image(plane)
    with plain_kernels():
        pq = qr.score_image(plane)
    agree_int8 = float((kq.argmax(-1) == pq.argmax(-1)).mean())

    # forward ms per plane: the padded plane at b1, one 10-crop chunk
    pad = np.zeros((1,) + tuple(-(-n // 32) * 32 for n in WV_HW) + (1,),
                   np.float32)
    pad[0, :WV_HW[0], :WV_HW[1], 0] = plane
    x_sp = torch.from_numpy(pad).to(dev)
    x_st = extract_tiles(x_sp[0], grid, stitched.tile_rows,
                         stitched.tile_cols)[:stitched.crop_batch]
    with torch.inference_mode():
        fwd = {"spatial_bf16": time_ms(lambda: bf16(x_sp), 1000.0),
               "stitched_bf16": chunks * time_ms(lambda: bf16(x_st),
                                                 1000.0),
               "spatial_int8": time_ms(lambda: q(x_sp), 1000.0)}
        stages = stage_breakdown(bf16, x_sp)
        profile = forward_profile(lambda: bf16(x_sp), fwd["spatial_bf16"])
        profile_st = forward_profile(lambda: bf16(x_st),
                                     fwd["stitched_bf16"] / chunks)
    result = {
        "phase": "wholeview", "card": card, "events": WV_EVENTS,
        "hw": list(WV_HW), "setup_s": setup_s, "crop_chunks": chunks,
        "runs": runs, "calib_tiles": n_tiles,
        "argmax_agreement_vs_f32": agree,
        "argmax_agreement_int8_kernel_vs_plain": agree_int8,
        "forward_ms_per_plane": fwd,
        "int8_over_bf16_spatial": fwd["spatial_int8"] / fwd["spatial_bf16"],
        "stitched_over_spatial": fwd["stitched_bf16"] / fwd["spatial_bf16"],
        "stage_ms_spatial": stages, "profile_spatial": profile,
        "profile_stitched": profile_st,
    }
    emit(result)
    for mode, a in agree.items():
        require(a >= 0.99, f"wholeview {mode}: kernel path vs f32 argmax "
                           f"agreement {a}")
    require(agree_int8 >= 0.99, f"wholeview int8 kernel path vs int8 plain "
                                f"path argmax agreement {agree_int8}")
    return _merge(*(r["launches"] for r in runs.values()))


def serve_path(dev, card, work):
    """The serve loop (cli/serve.py --once, --device cuda, the deploy
    smoke's weights) over two watch dirs: two precropped files of
    SERVE_CROPS 512² crops and a corrupt file (-b 16), then one
    whole-plane file of 2 events (--wholeview). Gates: the good files
    served with score sums 1 ± 1e-2, the corrupt one quarantined with
    its .failed marker, the shutdown line with the served count, exact
    launches (11 per batch, 11 per plane). Returns the launches."""
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.serve import main as serve
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file

    tar = os.path.join(work, "weights.tar")
    t0 = time.time()
    dirs = {}
    for name in ("crops", "planes"):
        for side in ("in", "out"):
            d = os.path.join(work, f"serve_{name}_{side}")
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
            dirs[name, side] = d
    for i, f in enumerate(("a.uevt", "b.uevt")):
        make_synthetic_file(os.path.join(dirs["crops", "in"], f),
                            n_events=SERVE_CROPS, hw=HW, seed=10 + i)
    with open(os.path.join(dirs["crops", "in"], "broken.uevt"), "wb") as f:
        f.write(b"not an event file")
    make_synthetic_file(os.path.join(dirs["planes", "in"], "wv.uevt"),
                        n_events=2, seed=1, wholeview=True)
    setup_s = time.time() - t0

    def run(name, *extra):
        printed, errors = io.StringIO(), io.StringIO()
        ops.reset_launch_counts()
        t0 = time.time()
        with contextlib.redirect_stdout(printed), \
                contextlib.redirect_stderr(errors):
            rc = serve(["--watch-dir", dirs[name, "in"], "--out-dir",
                        dirs[name, "out"], "-c", tar, "--once",
                        "--device", "cuda", *extra])
        torch.cuda.synchronize()
        require(rc == 0, f"serve {name} returned {rc}")
        lines = [json.loads(ln) for ln in printed.getvalue().splitlines()
                 if ln.startswith("{")]
        failed = [json.loads(ln) for ln in errors.getvalue().splitlines()
                  if ln.startswith("{")]
        return {"wall_s": time.time() - t0, "lines": lines,
                "failed": failed, "launches": ops.launch_counts()}

    crops = run("crops", "-b", str(BATCH_MAIN))
    planes = run("planes", "--wholeview")
    result = {"phase": "serve", "card": card, "setup_s": setup_s,
              "crops": crops, "planes": planes}
    emit(result)
    out = dirs["crops", "out"]
    require(crops["lines"][-1] == {"shutdown": True, "served": 2},
            f"serve crops: {crops['lines']}")
    require([ln.get("served") for ln in crops["lines"][:-1]]
            == ["a.uevt", "b.uevt"], f"serve crops: {crops['lines']}")
    require([f["failed"] for f in crops["failed"]] == ["broken.uevt"]
            and os.path.exists(os.path.join(out, "broken.uevt.failed"))
            and not os.path.exists(os.path.join(out, "broken_scores.uevt")),
            f"corrupt file not quarantined: {crops['failed']}")
    for f in ("a", "b"):
        _check_scores(os.path.join(out, f"{f}_scores.uevt"), SERVE_CROPS,
                      "uburn_plane2", HW)
    require(planes["lines"][-1] == {"shutdown": True, "served": 1},
            f"serve planes: {planes['lines']}")
    _check_scores(os.path.join(dirs["planes", "out"], "wv_scores.uevt"), 2,
                  "ubsnet_plane2", WV_HW)
    batches = 2 * -(-SERVE_CROPS // BATCH_MAIN)
    for name, got, n in (("crops", crops["launches"], batches),
                         ("planes", planes["launches"], 2)):
        exp = {k: LAUNCHES_PER_BATCH.get(k, 0) * n for k in got}
        require(got == exp, f"serve {name} launch counts {got} != {exp}")
    return _merge(crops["launches"], planes["launches"])


def _train_batch(seed):
    """One seeded batch of 16 synthetic 512² events (image, label,
    weight), as the loader assembles it."""
    import numpy as np

    from ubresnet_tpu_torch.data.synthetic import synth_event

    rng = np.random.RandomState(seed)
    evs = [synth_event(rng, HW) for _ in range(BATCH_MAIN)]
    return {"image": np.stack([e["wire"] for e in evs])[..., None],
            "label": np.stack([e["segment"] for e in evs]).astype(np.int32),
            "weight": np.stack([e["weight"] for e in evs])}


ZONE_KERNELS = ("conv_stats_kernel", "conv_dw_kernel", "conv_bn_act_kernel",
                "nll_fwd_kernel", "nll_bwd_kernel", "maxpool3x3s2_kernel",
                "sum_rows_kernel", "deconv2x_kernel", "conv_s2k4_kernel",
                "deconv_dw_kernel")


def step_profile(step, state, batch, step_ms, steps=2, detail=()):
    """Device time of ``steps`` train steps by kernel (torch.profiler):
    the train zone's kernels (ops/csrc) against everything else, the
    busy share of the CUDA-event step time, the largest other kernels
    and the per-step time of each kernel named in ``detail``. None of it
    gates; if the profiler sees no device time it says so."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    kernels, launches = _kernel_times(prof, steps)
    if not kernels:
        return {"device_time": "not measured (no CUDA events in the trace)"}
    zone = sum(ms for k, ms in kernels.items()
               if any(z in k for z in ZONE_KERNELS))
    busy = sum(kernels.values())
    others = sorted(((ms, k[:90]) for k, ms in kernels.items()
                     if not any(z in k for z in ZONE_KERNELS)), reverse=True)
    mine = {d: sum(ms for k, ms in kernels.items() if d in k)
            for d in detail}
    return {"device_busy_ms_per_step": busy, "zone_kernel_ms_per_step": zone,
            "kernel_ms_per_step": mine,
            "other_kernel_ms_per_step": busy - zone,
            "zone_share_of_step": zone / step_ms,
            "idle_share_of_step": max(0.0, 1 - busy / step_ms),
            "kernel_launches_per_step": launches,
            "top_other_kernels_ms": [[k, ms] for ms, k in others[:12]]}


def _kernel_times(prof, reps):
    """{kernel name: device ms per repetition} and launches per
    repetition from a torch.profiler run of ``reps`` repetitions."""
    import torch

    def is_kernel(e):  # device work, not a range annotated around it
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer."))

    kernels, launches = {}, 0
    for e in prof.key_averages():
        if not is_kernel(e):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3 / reps
        launches += e.count
    return kernels, launches / reps


def forward_profile(fn, fwd_ms, reps=3):
    """Device time of ``reps`` forwards by kernel (torch.profiler): the
    busy and idle shares of the CUDA-event forward time and the largest
    kernels. Reported, not gated."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels, launches = _kernel_times(prof, reps)
    if not kernels:
        return {"device_time": "not measured (no CUDA events in the trace)"}
    busy = sum(kernels.values())
    top = sorted(((ms, k[:90]) for k, ms in kernels.items()), reverse=True)
    return {"device_busy_ms_per_forward": busy,
            "idle_share_of_forward": max(0.0, 1 - busy / fwd_ms),
            "kernel_launches_per_forward": launches,
            "top_kernels_ms": [[k, ms] for ms, k in top[:16]]}


def _adam_steps(step, state, b, n=5):
    """``n`` train steps on one batch, each timed with CUDA events:
    (state, losses, ms per step)."""
    import torch

    losses, times = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, b)
        end.record()
        end.synchronize()
        losses.append(m["loss"])
        times.append(start.elapsed_time(end))
    return state, losses, times


def _loss_grads(sd, pol, b, dev):
    """Loss and parameter gradients (f32 copies) of one train-mode
    forward and backward of ``sd`` under ``pol`` on batch ``b``: the
    loss kernel where the train zone is on, as the trainer runs it."""
    import torch

    from ubresnet_tpu_torch.losses import pixelwise_weighted_nll_from_logits
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.loss import weighted_nll

    model = get_model("uresnet", sd, policy=pol, device=dev, train=True)
    logits = model(b["image"], logits=True)
    if pol.fused_train:
        loss = weighted_nll(logits, b["label"], b["weight"])
    else:
        loss = pixelwise_weighted_nll_from_logits(logits, b["label"],
                                                  b["weight"])
    loss.backward()
    out = (loss.item(), {k: p.grad.float().clone()
                         for k, p in model.named_parameters()})
    del model, logits, loss
    torch.cuda.empty_cache()
    return out


def _vs_f32(loss, grads, ref):
    """A path's loss and max|Δgrad|/max|grad| from the f32 path's
    (``ref``), with the worst parameter and the median."""
    import numpy as np

    l32, g32, gsc = ref["loss_f32"], ref["grads_f32"], ref["grad_scale"]
    per = {k: float((grads[k] - g32[k]).abs().max()) / gsc for k in g32}
    worst = max(per, key=per.get)
    return {"loss": loss, "loss_rel_vs_f32": abs(loss - l32) / abs(l32),
            "grad_err_vs_f32": per[worst], "worst_param": worst,
            "grad_err_median_vs_f32": float(np.median(list(per.values())))}


def train_parity(dev, card):
    """Loss and gradients of the train kernel path against the plain
    bf16 and f32 paths on one batch, then 5 Adam steps. Returns what
    ``train_deconv`` holds its path against: the plain paths' results
    and gates, and this path's step ms."""
    import dataclasses

    import numpy as np
    import torch

    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    sd = random_state_dict(seed=0)
    batch = _train_batch(7)
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    kernel_pol = Policy()
    paths = {"kernel_bf16": kernel_pol,
             "plain_bf16": dataclasses.replace(kernel_pol, fused_train=False),
             "plain_f32": Policy.f32()}
    res = {name: _loss_grads(sd, pol, b, dev) for name, pol in paths.items()}
    l32, g32 = res["plain_f32"]
    gsc = max(float(g.abs().max()) for g in g32.values())
    ref = {"loss_f32": l32, "grads_f32": g32, "grad_scale": gsc}
    kern = _vs_f32(*res["kernel_bf16"], ref)
    plain = _vs_f32(*res["plain_bf16"], ref)
    lk, gk = res["kernel_bf16"]
    lp, gp = res["plain_bf16"]
    kp = max(float((gk[k] - gp[k]).abs().max()) for k in gk) / gsc
    loss_gate = max(2 * plain["loss_rel_vs_f32"], 1e-3)
    grad_gate = max(2 * plain["grad_err_vs_f32"], 1e-2)
    result = {"phase": "train_parity", "card": card, "batch": BATCH_MAIN,
              "hw": list(HW), "loss_f32": l32, "grad_scale_f32": gsc,
              "kernel_bf16": kern, "plain_bf16": plain,
              "kernel_vs_plain_bf16": {
                  "loss_rel": abs(lk - lp) / abs(lp), "grad_err": kp},
              "gates": {"loss_rel_vs_f32": loss_gate,
                        "grad_err_vs_f32": grad_gate}}
    ref.update(plain_bf16=plain, gates=result["gates"])
    del res, gk, gp
    torch.cuda.empty_cache()

    # 5 Adam steps on the batch: the loss must fall; steps 2-5 timed
    model = get_model("uresnet", sd, policy=kernel_pol, device=dev,
                      train=True)
    opt = make_optimizer(model.parameters(), "adam", 1e-3, weight_decay=1e-4)
    step = build_train_step(use_pallas_loss=True, device=dev)
    state = create_train_state(model, opt)
    torch.cuda.reset_peak_memory_stats()
    state, losses, times = _adam_steps(step, state, b)
    step_ms = sum(times[1:]) / len(times[1:])
    result.update({"adam_losses": losses, "adam_step_ms": times,
                   "train_step_ms_b16": step_ms,
                   "train_crops_per_s_b16": BATCH_MAIN / step_ms * 1e3,
                   "train_peak_mem_gib":
                       torch.cuda.max_memory_allocated() / 2 ** 30,
                   "step_profile": step_profile(step, state, b, step_ms)})
    emit(result)
    require(kern["loss_rel_vs_f32"] <= loss_gate,
            f"kernel path loss {kern['loss_rel_vs_f32']} from f32 > "
            f"{loss_gate}")
    require(kern["grad_err_vs_f32"] <= grad_gate,
            f"kernel path grads {kern['grad_err_vs_f32']} from f32 > "
            f"{grad_gate}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"5 Adam steps did not lower the loss: {losses}")
    ref["step_ms"] = step_ms
    return ref


DECONV_KERNELS = ("deconv2x_kernel", "conv_s2k4_kernel", "deconv_dw_kernel")


def train_deconv(dev, card, ref, rows):
    """train_parity's batch and weights through the train step with
    Policy.fused_train_deconv: loss and gradients against the plain
    paths ``ref`` holds, under train_parity's gates; then 5 Adam steps
    with exact launch counts (the main path of this configuration,
    counted from 0 just before them). Also reported: deconv2x_ad's
    forward + backward against cuDNN's (F.conv_transpose2d + autograd,
    bf16) from this run's kernel ``rows``. Returns the launches."""
    import dataclasses

    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    sd = random_state_dict(seed=0)
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in _train_batch(7).items()}
    pol = dataclasses.replace(Policy(), fused_train_deconv=True)
    kern = _vs_f32(*_loss_grads(sd, pol, b, dev), ref)
    model = get_model("uresnet", sd, policy=pol, device=dev, train=True)
    require(sum(getattr(m, "ad", False) for m in model.modules()) == 2,
            "fused_train_deconv routes other than dec2 and dec1")
    opt = make_optimizer(model.parameters(), "adam", 1e-3, weight_decay=1e-4)
    step = build_train_step(use_pallas_loss=True, device=dev)
    state = create_train_state(model, opt)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, losses, times = _adam_steps(step, state, b)
    launches = ops.launch_counts()
    want = {k: 5 * LAUNCHES_PER_DECONV_STEP.get(k, 0) for k in launches}
    step_ms = sum(times[1:]) / len(times[1:])
    gates = ref["gates"]
    ad = [r for r in rows if r["kernel"] == "deconv2x_ad"]
    ad_ms = sum(r["ms"] for r in ad)
    cudnn_ms = sum(r["library_ms"] for r in ad)
    result = {"phase": "train_deconv", "card": card, "batch": BATCH_MAIN,
              "hw": list(HW), "kernel_bf16_deconv_ad": kern,
              "plain_bf16": ref["plain_bf16"], "gates": gates,
              "launches": launches, "launches_want": want,
              "adam_losses": losses, "adam_step_ms": times,
              "train_step_ms_b16": step_ms,
              "train_step_ms_b16_default_zone": ref["step_ms"],
              "deconv2x_ad_fwd_bwd_ms": ad_ms,
              "cudnn_fwd_bwd_ms": cudnn_ms,
              "deconv2x_ad_over_cudnn": ad_ms / cudnn_ms,
              "train_crops_per_s_b16": BATCH_MAIN / step_ms * 1e3,
              "train_peak_mem_gib":
                  torch.cuda.max_memory_allocated() / 2 ** 30,
              "step_profile": step_profile(step, state, b, step_ms,
                                           detail=DECONV_KERNELS)}
    emit(result)
    require(kern["loss_rel_vs_f32"] <= gates["loss_rel_vs_f32"],
            f"deconv-AD path loss {kern['loss_rel_vs_f32']} from f32 > "
            f"{gates['loss_rel_vs_f32']}")
    require(kern["grad_err_vs_f32"] <= gates["grad_err_vs_f32"],
            f"deconv-AD path grads {kern['grad_err_vs_f32']} from f32 > "
            f"{gates['grad_err_vs_f32']}")
    require(launches == want, f"deconv-AD launch counts {launches} != {want}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"5 Adam steps did not lower the loss: {losses}")
    return launches


def train_path(dev, card, work):
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.train import main as train_cli
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model

    data = os.path.join(work, "train.uevt")
    ckpt = os.path.join(work, "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.time()
    make_synthetic_file(data, n_events=EVENTS, hw=HW, seed=1)
    cfg = {"model": {"precision": "bf16"},
           "optim": {"name": "adam", "lr": 1e-3},
           "train_data": {"files": [data], "batch_size": BATCH_MAIN},
           "valid_data": {"files": [data], "batch_size": BATCH_MAIN},
           "num_iters": TRAIN_ITERS, "print_every": 1,
           "valid_every": VALID_EVERY, "valid_batches": 1,
           "checkpoint_every": 4, "checkpoint_dir": ckpt, "seed": 0}
    cfg_path = os.path.join(work, "train.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    setup_s = time.time() - t0

    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = train_cli(["--config", cfg_path, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    out = printed.getvalue()
    summary = json.loads(out[out.rfind("\n{\n") + 1:])
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("iter ")]
    valid_forwards = TRAIN_ITERS // VALID_EVERY
    want = {k: (LAUNCHES_PER_TRAIN_STEP.get(k, 0) * TRAIN_ITERS
                + LAUNCHES_PER_BATCH.get(k, 0) * valid_forwards)
            for k in launches}

    final = summary.get("final_checkpoint")
    sums_dev = None
    if final and os.path.exists(final):
        sd, _ = load_reference_checkpoint(final)
        crop = _train_batch(11)["image"][:1]
        with torch.inference_mode():
            lp = get_model("uresnet", sd, device=dev)(
                torch.from_numpy(crop).to(dev))
        sums_dev = float((lp.exp().sum(-1) - 1).abs().max())
    step_s = summary.get("meters", {}).get("time/step")
    result = {"phase": "train", "card": card, "events": EVENTS,
              "batch": BATCH_MAIN, "hw": list(HW), "iters": TRAIN_ITERS,
              "rc": rc, "setup_s": setup_s, "cli_wall_s": wall,
              "losses": losses, "final_iter": summary.get("final_iter"),
              "launches": launches, "launches_want": want,
              "host_step_ms_mean": step_s * 1e3 if step_s else None,
              "meters": summary.get("meters"),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "final_tar_prob_sum_max_dev": sums_dev}
    emit(result)
    require(rc == 0 and "error" not in summary, f"train CLI failed:\n{out}")
    require(summary["final_iter"] == TRAIN_ITERS,
            f"final_iter {summary['final_iter']}")
    require(len(losses) == TRAIN_ITERS and np.isfinite(losses).all(),
            f"losses {losses}")
    require(launches == want, f"train launch counts {launches} != {want}")
    require(sums_dev is not None and sums_dev <= 1e-2,
            f"final .tar scores: probability sums off by {sums_dev}")
    return launches


def qat_path(dev, card, work):
    """int8 QAT through the training CLI (--set model.qat=true) on the
    train phase's 64 events: 4 iterations and one validation, exact
    launch counts, finite losses, a final .tar that scores; then the
    int8 ladder tool at 512², reported. Returns the CLI's launches."""
    import numpy as np
    import torch

    from ubresnet_tpu_torch import ops
    from ubresnet_tpu_torch.cli.train import main as train_cli
    from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.tools import int8_ladder

    data = os.path.join(work, "train.uevt")  # written by train_path
    ckpt = os.path.join(work, "qat_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = {"model": {"precision": "bf16"},
           "optim": {"name": "adam", "lr": 1e-4},
           "train_data": {"files": [data], "batch_size": BATCH_MAIN},
           "valid_data": {"files": [data], "batch_size": BATCH_MAIN},
           "num_iters": QAT_ITERS, "print_every": 1,
           "valid_every": QAT_ITERS, "valid_batches": 1,
           "checkpoint_every": QAT_ITERS, "checkpoint_dir": ckpt, "seed": 2}
    cfg_path = os.path.join(work, "qat.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = train_cli(["--config", cfg_path, "--set", "model.qat=true",
                        "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ops.launch_counts()
    out = printed.getvalue()
    summary = json.loads(out[out.rfind("\n{\n") + 1:])
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("iter ")]
    want = {k: (LAUNCHES_PER_TRAIN_STEP.get(k, 0) * QAT_ITERS
                + LAUNCHES_PER_QAT_VALID.get(k, 0)) for k in launches}
    final = summary.get("final_checkpoint")
    sums_dev = None
    if final and os.path.exists(final):
        sd, _ = load_reference_checkpoint(final)
        crop = _train_batch(11)["image"][:1]
        with torch.inference_mode():
            lp = get_model("uresnet", sd, device=dev)(
                torch.from_numpy(crop).to(dev))
        sums_dev = float((lp.exp().sum(-1) - 1).abs().max())
    step_s = summary.get("meters", {}).get("time/step")
    result = {"phase": "qat", "card": card, "events": EVENTS,
              "batch": BATCH_MAIN, "hw": list(HW), "iters": QAT_ITERS,
              "rc": rc, "cli_wall_s": wall, "losses": losses,
              "final_iter": summary.get("final_iter"),
              "launches": launches, "launches_want": want,
              "host_step_ms_mean": step_s * 1e3 if step_s else None,
              "meters": summary.get("meters"),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "final_tar_prob_sum_max_dev": sums_dev}
    emit(result)
    require(rc == 0 and "error" not in summary,
            f"QAT train CLI failed:\n{out}")
    require(summary["final_iter"] == QAT_ITERS,
            f"final_iter {summary['final_iter']}")
    require(len(losses) == QAT_ITERS and np.isfinite(losses).all(),
            f"losses {losses}")
    require(launches == want, f"QAT launch counts {launches} != {want}")
    require(sums_dev is not None and sums_dev <= 1e-2,
            f"final .tar scores: probability sums off by {sums_dev}")

    printed = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        rc = int8_ladder.main([str(LADDER_STEPS), "--device", "cuda"])
    torch.cuda.synchronize()
    lines = printed.getvalue().strip().splitlines()
    require(rc == 0 and len(lines) == 1, f"int8 ladder printed {lines}")
    emit({"phase": "int8_ladder", "card": card, "seconds": time.time() - t0,
          "train_batch": int8_ladder.TRAIN_BATCH,
          "result_not_gated": json.loads(lines[0])})
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only "
              "on the card", file=sys.stderr)
        return 1
    from ubresnet_tpu_torch.ops import _build
    from ubresnet_tpu_torch.utils.platform import strict_f32

    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    t0 = time.time()
    lib = _build.build()
    report = _build.ptxas_report()
    PTXAS.update({r["kernel"]: {k: r.get(k) for k in (
        "registers", "spill_stores", "spill_loads", "stack_bytes")}
        for r in report})
    emit({"phase": "build", "seconds": time.time() - t0, "library": str(lib),
          "ptxas": report})

    strict_f32()  # the plain versions are f32 cuDNN convs: no TF32
    dev = torch.device("cuda", 0)
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    rows = check_kernels(kernel_rows(dev))
    rows += check_kernels(int8_kernel_rows(dev, rows))
    for B, hw in WV_SHAPES:  # the zone at the wholeview paths' shapes
        wv = check_kernels(kernel_rows(dev, B, hw))
        rows += wv + check_kernels(int8_kernel_rows(dev, wv, B, hw))
        torch.cuda.empty_cache()
    rows += check_kernels(train_kernel_rows(dev))
    rows += check_kernels(deconv_ad_rows(dev))
    emit(train_zone_per_step(rows))
    emit(train_zone_per_step(rows, "per_step_ad", LAUNCHES_PER_DECONV_STEP,
                             "train_deconv_per_step"))
    torch.cuda.empty_cache()
    launches = {"precropped": main_path(dev, card, work)}
    ref = train_parity(dev, card)
    torch.cuda.empty_cache()
    launches["train_deconv"] = train_deconv(dev, card, ref, rows)
    del ref
    torch.cuda.empty_cache()
    launches["train"] = train_path(dev, card, work)
    torch.cuda.empty_cache()
    launches["qat"] = qat_path(dev, card, work)
    torch.cuda.empty_cache()
    launches["int8"] = int8_path(dev, card, work)
    torch.cuda.empty_cache()
    launches["wholeview"] = wholeview_path(dev, card, work)
    torch.cuda.empty_cache()
    launches["serve"] = serve_path(dev, card, work)
    line = kernels_line(rows, launches)
    for k in line["kernels"]:
        paths = SOURCES[k["name"]][3]
        require(all(k["launches_by_path"][p] > 0 for p in paths),
                f"{k['name']} was not launched on its main path "
                f"{paths}: {k['launches_by_path']}")
    emit(line)
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
