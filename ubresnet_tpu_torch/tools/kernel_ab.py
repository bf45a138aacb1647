"""Kernel rows of one checkout on the card, for A/B against another.

    python ubresnet_tpu_torch/tools/kernel_ab.py ROOT KERNEL[,KERNEL...] [IP]

Builds the kernels of the checkout at ROOT (its own ``ubresnet_tpu_torch``,
into ROOT/build/kernels) and runs ROOT's ``chip_smoke.py`` kernel rows —
eval, int8, train and deconv-AD — whose kernel is one of the KERNEL names
(the rows' ``kernel`` field: ``deconv_dw``, ``basic_block_s8``,
``deconv2x_ad``, ...), each checked against its plain version and timed
as ``chip_smoke.py`` does it. int8 rows also need the bf16 eval rows
(their ``bf16_kernel_ms``), which then run too. Train and deconv-AD rows
also give a ``host`` line: the wall µs a call of back-to-back calls (a
host-bound row's whole cost, such as ``deconv2x_ad``'s autograd). Every
line is tagged with ROOT and the card; a last ``kernel_ab`` line sums
ms, bound and library ms per kernel. IP (8 or 4) takes the deconv-AD rows
of the UResNet at inplanes IP (the 8-channel streams) in place
of the flagship's; IP 32 the reference trainer's inplanes-32 train rows
(256² crops) and its dec1 deconv-AD row.

Run it by path, not with ``-m``, so that ROOT's package, not this one,
is imported; run it once per checkout in turns (parent, change, change,
parent) in one call to compare two commits on one card. Needs a card.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import time

EVAL_KERNELS = {"conv_bn_act", "basic_block", "deconv2x", "maxpool3x3s2"}
INT8_KERNELS = {"conv_bn_act_s8", "basic_block_s8", "deconv2x_s8"}


def host_us(fn, n=50):
    """Host µs a call: the wall time of ``n`` back-to-back calls with one
    synchronise at each end (after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    root, want = os.path.abspath(argv[0]), set(argv[1].split(","))
    ip = int(argv[2]) if len(argv) == 3 else None
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from ubresnet_tpu_torch.ops import _build
    from ubresnet_tpu_torch.utils.platform import strict_f32

    card = cs.card_line()
    _build.build()
    cs.PTXAS.update({r["kernel"]: {k: r.get(k) for k in (
        "registers", "spill_stores", "spill_loads", "stack_bytes")}
        for r in _build.ptxas_report()})
    emit = cs.emit
    cs.emit = lambda obj: emit({**obj, "root": root, "card": card})
    strict_f32()
    dev = torch.device("cuda", 0)

    int8 = want & INT8_KERNELS
    eval_rows = (cs.check_kernels(cs.kernel_rows(dev))
                 if int8 or want & EVAL_KERNELS else [])
    rows = [r for r in eval_rows if r["kernel"] in want]
    if int8:
        rows += cs.check_kernels([r for r in cs.int8_kernel_rows(
            dev, eval_rows) if r["kernel"] in want])
    if ip == 32:
        train_rows = cs.train_kernel_rows(
            dev, cs.TRAIN_ZONE_32, cs.CLASSIFIER_32, model="inplanes 32",
            cell_hw=cs.TRAIN_HW_32, loss_rows=False)
        deconv_rows = cs.deconv_ad_rows(
            dev, (("dec1", 128, 64, 32),), model="inplanes 32",
            cell_hw=cs.TRAIN_HW_32)
    else:
        train_rows = cs.train_kernel_rows(dev)
        deconv_rows = (cs.deconv_ad_rows(dev) if ip is None else
                       cs.deconv_ad_rows(dev, cs.DECONV_AD_8[ip],
                                         model=f"inplanes {ip}"))
    for made in (train_rows, deconv_rows):
        mine = [r for r in made if r["kernel"] in want]
        if mine:
            rows += cs.check_kernels(mine)
        for r in mine:  # the host's share: whole calls back to back
            cs.emit({"phase": "host", "layer": r["layer"],
                     "kernel": r["kernel"],
                     "host_us_per_call": host_us(r["kfn"])})
    totals = {}
    for r in rows:
        k = totals.setdefault(r["kernel"], {"rows": 0, "ms": 0.0,
                                            "bound_ms": 0.0,
                                            "library_ms": 0.0})
        k["rows"] += 1
        k["ms"] += r["ms"]
        k["bound_ms"] += r["bound_ms"]
        k["library_ms"] = (None if k["library_ms"] is None
                           or r["library_ms"] is None
                           else k["library_ms"] + r["library_ms"])
    cs.emit({"phase": "kernel_ab", "kernels": totals})
    return 0


if __name__ == "__main__":
    sys.exit(main())
