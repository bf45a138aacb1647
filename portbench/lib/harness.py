"""One run of one cell: set-up, window and comparison by the traffic
kind's code (``kinds/<kind>.py``), then the metrics the cell reports
and the result line's fields."""
from __future__ import annotations

import sys
from typing import Callable

from portbench.lib import check, common, trace
from portbench.work import arith


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def work_of(cell: common.Cell) -> dict:
    """Per call (a forward of a batch, or a training step): the model's
    FLOPs and the kernel-zone work by kernel family."""
    cfg, tr = cell.config, cell.traffic
    B, hw = tr["batch"], tuple(tr["crop_hw"])
    fwd = 2 * arith.forward_macs(cfg, hw) * B
    if tr["kind"] == "train":
        rows = arith.train_rows(cell.work["train"], B, hw,
                                cfg["num_classes"])
        return {"flops": 3 * fwd, "kernels": arith.by_kernel(rows)}
    rows = arith.eval_rows(cell.work["eval"], B, hw)
    return {"flops": fwd, "kernels": arith.by_kernel(rows)}


def run_cell(cell: common.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float, control: bool = False,
             say: Callable[[str], None] = log, readings: dict = None
             ) -> dict:
    """The result line's fields (``checks`` last) for one run;
    ``readings`` (a dict) receives every number compared, limited or
    not."""
    import torch

    tr = cell.traffic
    stretch = trace.Stretch(torch, traced, tr["trace_calls"],
                            tr["label_calls"])
    out = common.kind_module(tr["kind"]).run(
        cell, seed, seconds, stretch, device, t_start, say, control=control)
    ctx = {"dispatch_s": out.get("dispatch_s"),
           "latency_s": out.get("latency_s"), "quiet": out["quiet"],
           "work": work_of(cell),
           "maps": trace.kernel_maps(common.BENCH_DIR), "trace": {}}
    if traced:
        ctx["trace"] = trace.reduce(stretch, torch, ctx["maps"])
    numbers = out["check"]()
    if readings is not None:
        readings.update(numbers)
    ok, checks = check.verdict(numbers, cell.limits)
    for name, v in numbers.items():
        if name not in checks:
            say(f"unlimited reading {name} = {v!r}")
    metrics = {}
    if traced:
        for m in cell.per_layer:
            reader = common.load_module(common.BENCH_DIR / "metrics"
                                        / f"{m['name']}.py")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    dev = (common.device_line(torch, device, out["peak_bytes"])
           if device.type == "cuda" else
           {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0})
    result = {"correct": bool(ok), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced and ctx["trace"]:
        t = ctx["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = checks
    return result
