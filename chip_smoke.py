#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ubresnet_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero:

1. device  — the card's name and power limit (nvidia-smi); no card,
             no run: without CUDA the script exits 1 before anything.
2. build   — nvcc builds the four Hopper kernels from
             ubresnet_tpu_torch/ops/csrc for sm_90a.
3. kernels — every kernel-zone layer of the flagship UResNet at its
             main-path shape and batch (16): the kernel against its plain
             PyTorch version on the same bf16 inputs (max abs error
             ≤ 1e-2·max|plain| for K1-K3, exact for K4), the kernel's,
             the plain version's and the library call's time (CUDA
             events), and the bound from the bytes and operations.
4. main    — 64 synthetic 512x512 crops scored file → file through the
             port's CLI (-b 16, cuda) with seeded random weights in a
             reference-format .tar; every event must carry 3 score
             images summing to 1 ± 1e-2, every kernel must have run its
             11-launches-per-batch share, and the kernel path must
             agree with the plain f32 path (TF32 off) on the argmax of
             the 16 crops of the timed forward for ≥ 99% of pixels.
             Also forward-only crops/s and a second, warm CLI run.
5. summary — the kernels line, the card line, then the result line.

Scratch files go under build/chip_smoke in the checkout.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12  # H100 SXM dense bf16 tensor cores
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
EVENTS, BATCH_MAIN, HW = 64, 16, (512, 512)
LAUNCHES_PER_BATCH = {"conv_bn_act": 2, "basic_block": 6, "deconv2x": 2,
                      "maxpool3x3s2": 1}
SOURCES = {
    "conv_bn_act": ("ubresnet_tpu_torch/ops/csrc/conv_bn_act.cu",
                    "ubresnet_tpu/ops/pallas_conv.py:315 fused_packed_conv"),
    "basic_block": ("ubresnet_tpu_torch/ops/csrc/basic_block.cu",
                    "ubresnet_tpu/ops/pallas_conv.py:1483 fused_basic_block"
                    " + :699 fused_dual_block"),
    "deconv2x": ("ubresnet_tpu_torch/ops/csrc/deconv2x.cu",
                 "ubresnet_tpu/ops/pallas_conv.py:898 fused_packed_deconv2x"),
    "maxpool3x3s2": ("ubresnet_tpu_torch/ops/csrc/maxpool3x3s2.cu",
                     "ubresnet_tpu/ops/pallas_conv.py:525 fused_pool3x3s2"),
}


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


def kernel_rows(dev):
    """One row per kernel-zone layer: (layer, kernel, kernel fn, plain
    fn, library fn, bytes moved, operations, operation peak)."""
    import torch
    import torch.nn.functional as F

    from ubresnet_tpu_torch.ops import block, conv, deconv, pool

    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B = BATCH_MAIN

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

    # K4 stem pool: 512^2 x 16 -> 256^2 x 16
    x = act(B, 512, 512, 16)
    out_elems = B * 256 * 256 * 16
    rows.append(("stem pool", "maxpool3x3s2",
                 lambda x=x: pool.maxpool3x3s2(x),
                 lambda x=x: pool.maxpool3x3s2_plain(x),
                 lambda x=x: F.max_pool2d(cl(x), 3, 2, 1),
                 n2(x) + out_elems * 2, 8 * out_elems, F32_FLOPS))

    # K2 blocks
    def block_row(name, hw, ca, cb, co, proj):
        a = act(B, hw, hw, ca)
        b = act(B, hw, hw, cb) if cb else None
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

        pix = B * hw * hw
        macs = pix * (9 * cin * co + 9 * co * co + (cin * co if proj else 0))
        nbytes = n2(a) + (n2(b) if cb else 0) + pix * co * 2 + n2(w1) + n2(w2)
        rows.append((name, "basic_block",
                     lambda: block.basic_block(*args),
                     lambda: block.basic_block_plain(*args),
                     library, nbytes, 2 * macs, BF16_TENSOR_FLOPS))

    block_row("enc1.res1", 256, 16, 0, 32, True)
    block_row("enc1.res2", 256, 32, 0, 32, False)

    def deconv_row(name, hw, ci, co):
        x = act(B, hw, hw, ci)
        w = weight(4, 4, ci, co, fan=16 * co)
        w_iohw = w.permute(2, 3, 0, 1).contiguous()
        out_pix = B * 4 * hw * hw
        rows.append((name, "deconv2x",
                     lambda: deconv.deconv2x(x, w),
                     lambda: deconv.deconv2x_plain(x, w),
                     lambda: F.conv_transpose2d(cl(x), w_iohw, stride=2,
                                                padding=1),
                     n2(x) + out_pix * co * 2 + n2(w),
                     2 * out_pix * 4 * ci * co, BF16_TENSOR_FLOPS))

    deconv_row("dec2.deconv", 128, 64, 32)
    block_row("dec2.res.res1", 256, 32, 32, 32, True)
    block_row("dec2.res.res2", 256, 32, 0, 32, False)
    deconv_row("dec1.deconv", 256, 32, 16)
    block_row("dec1.res.res1", 512, 16, 16, 16, True)
    block_row("dec1.res.res2", 512, 16, 0, 16, False)

    # K1 head conv10 (BN + ReLU) and classifier conv11 (bias only)
    def conv_row(name, co, act_on):
        x = act(B, 512, 512, 16)
        w = weight(7, 7, 16, co, fan=49 * co)
        g, b = affine(co)
        if not act_on:
            g = torch.ones(co, device=dev)
        lw, lb = folded(w, g), b.to(bf)

        def library():
            y = F.conv2d(cl(x), lw, lb, padding=3)
            return torch.relu_(y) if act_on else y

        pix = B * 512 * 512
        rows.append((name, "conv_bn_act",
                     lambda: conv.conv_bn_act(x, w, g, b, act=act_on),
                     lambda: conv.conv_bn_act_plain(x, w, g, b, act=act_on),
                     library, n2(x) + pix * co * 2 + n2(w),
                     2 * pix * 49 * 16 * co, BF16_TENSOR_FLOPS))

    conv_row("head conv10", 16, True)
    conv_row("classifier conv11", 3, False)
    return rows


def check_kernels(dev):
    import torch

    results = []
    for layer, kname, kfn, pfn, lfn, nbytes, ops, peak in kernel_rows(dev):
        got = kfn()
        want = pfn()
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{layer}: kernel {tuple(got.shape)} {got.dtype} vs plain "
                f"{tuple(want.shape)} {want.dtype}")
        err = float((got.float() - want.float()).abs().max())
        ref = float(want.float().abs().max())
        tol = 0.0 if kname == "maxpool3x3s2" else 1e-2 * ref
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / peak * 1e3
        row = {
            "phase": "kernel", "layer": layer, "kernel": kname,
            "shape": list(got.shape), "max_abs_err": err, "max_abs_ref": ref,
            "tolerance": tol, "ms": time_ms(kfn), "plain_ms": time_ms(pfn),
            "library_ms": time_ms(lfn), "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops, "bytes_ms": t_bytes,
            "ops_ms": t_ops,
        }
        emit(row)
        require(err <= tol, f"{layer}: kernel disagrees with its plain "
                            f"version: max abs err {err} > {tol}")
        results.append(row)
    return results


def kernels_line(rows, launches):
    out = []
    for name, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == name]
        t_bytes = sum(r["bytes_ms"] for r in mine)
        t_ops = sum(r["ops_ms"] for r in mine)
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in mine),
            "layers": [r["layer"] for r in mine],
        })
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


def main_path(dev, card):
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

    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
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
    want = {k: v * batches for k, v in LAUNCHES_PER_BATCH.items()}
    require(launches == want, f"launch counts {launches} != {want}")

    reader = EventFileReader(out)
    require(len(reader) == EVENTS, f"{len(reader)} events written")
    worst = 0.0
    for i in range(EVENTS):
        imgs = reader.read_entry(i)["uburn_plane2"]
        require(len(imgs) == 3, f"event {i}: {len(imgs)} score images")
        s = np.stack([im.pixels for im in imgs], -1).astype(np.float32)
        require(s.shape == HW + (3,) and np.isfinite(s).all(),
                f"event {i}: bad scores {s.shape}")
        worst = max(worst, float(np.abs(s.sum(-1) - 1.0).max()))
    require(worst <= 1e-2, f"score sums off by {worst}")

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
        "stage_ms_b16": stages,
        "argmax_agreement_b16_vs_f32": agree, "score_sum_max_dev": worst,
        "launches": launches, "timing": timing, "timing_warm": timing_warm,
        "crops_per_s_runner": EVENTS / timing["total"],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    emit(result)
    require(agree >= 0.99, f"kernel path vs f32 argmax agreement {agree}")
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
    emit({"phase": "build", "seconds": time.time() - t0, "library": str(lib)})

    strict_f32()  # the plain versions are f32 cuDNN convs: no TF32
    dev = torch.device("cuda", 0)
    rows = check_kernels(dev)
    launches = main_path(dev, card)
    emit(kernels_line(rows, launches))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
