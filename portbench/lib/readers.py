"""What the per-layer readers (``metrics/*.py``) share. Each reader takes
the run's context (lib/harness.py: the reduced trace of the traced
stretch, the zone's work per call, the harness's host spans) and
returns a number, or None where it finds nothing to read: no trace, a
kernel that did not run, or launches that do not match the work table,
whose bound would then count other work than the kernel did."""
from __future__ import annotations

import statistics
from typing import Optional

from portbench.work.arith import BF16_TENSOR_FLOPS


def roofline(ctx: dict, kernel: str) -> Optional[float]:
    """% of its bound: the zone work's bound seconds over the device
    seconds of the kernel's launches in the stretch."""
    t = ctx["trace"]
    w = ctx["work"]["kernels"].get(kernel)
    f = t.get("families", {}).get(kernel) if t else None
    if not (t and w and f) or f["device_s"] <= 0:
        return None
    if f["launches"] != w["launches"] * t["calls"]:
        return None
    return 100.0 * w["bound_s"] * t["calls"] / f["device_s"]


def zone_roofline(ctx: dict) -> Optional[float]:
    """% of the bound over every zone kernel of the work table together;
    None unless each ran as the table says."""
    t = ctx["trace"]
    if not t:
        return None
    bound = device = 0.0
    for kernel, w in ctx["work"]["kernels"].items():
        f = t["families"].get(kernel)
        if not f or f["launches"] != w["launches"] * t["calls"]:
            return None
        bound += w["bound_s"] * t["calls"]
        device += f["device_s"]
    return 100.0 * bound / device if device > 0 else None


def mfu(ctx: dict) -> Optional[float]:
    """% of the bf16 tensor peak: the model's FLOPs of the calls made
    after the traced stretches over their seconds on the host's clock
    (the profiles slow the host, lib/trace.py)."""
    q = ctx["quiet"]
    if not q["calls"] or q["seconds"] <= 0:
        return None
    flops = ctx["work"]["flops"] * q["calls"]
    return 100.0 * flops / q["seconds"] / BF16_TENSOR_FLOPS


def idle_pct(ctx: dict) -> Optional[float]:
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launches_per_call(ctx: dict) -> Optional[float]:
    t = ctx["trace"]
    if not t or not t["calls"]:
        return None
    return t["launches"] / t["calls"]


def dispatch_ms(ctx: dict) -> Optional[float]:
    """Median host ms of the runner's ``_dispatch`` over the window's
    batches sent after the traced stretches."""
    d = ctx.get("dispatch_s")
    return 1e3 * statistics.median(d) if d else None


def batch_p95_ms(ctx: dict) -> Optional[float]:
    """95th percentile ms from a batch's dispatch to its scores on the
    host, over the window's batches sent after the traced stretches."""
    from portbench.lib.common import quantile

    lat = ctx.get("latency_s")
    return 1e3 * quantile(lat, 0.95) if lat else None
