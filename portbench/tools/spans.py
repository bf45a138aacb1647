"""One run of a cell with the port's span recorder switched on or off
(ubresnet_tpu_torch/utils/profiling.py: ``recording``), and what the
spans of its window read:

    python portbench/tools/spans.py --workload u16.score.b16 --seed 7 \
        --seconds 20 --record 1 [--trace 1]

from the root of a checkout, on the card. The run is the benchmark's own
(lib/harness.py:run_cell), so ``--record 0`` is a plain run, and runs
with 0 and 1 in turns give the recorder's cost in the cell's end-to-end
metrics. Recording, the spans read are those that began when no profile
ran (``Stretch.quiet_from``: the window's start untraced, after both
traced stretches with ``--trace 1``). Per name, their count and median
ms; per request of the cell's kind, the medians a per-layer metric would
read: ``sparsify_ms`` (``runner.sparsify``), ``fetch_wait_ms``
(``runner.wait``: the host blocked on the card) and ``dispatch_ms``
(``runner.dispatch``) a batch; ``step_host_ms`` (``train.step`` less
its ``train.sync*`` children) and ``sync_wait_ms`` (those children
summed) a step. With ``--trace 1`` also ``idle_by_span``: the host
stretch's idle device seconds by the innermost ``ubresnet.*`` range
open at each gap's middle, found by time however many host events lie
between (the breakdown's label looks back a fixed number of events).
One line of JSON on standard output: {workload, seed, record, trace,
result (the benchmark's result line), spans, reads, idle_by_span}.
"""
import argparse
import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def _ms(values):
    return 1e3 * statistics.median(values) if values else None


def span_reads(records, since):
    """({name: {count, median_ms}}, {reading: median ms}) of the spans
    that began at or after ``since`` on the host's clock."""
    recs = [r for r in records if r.end is not None and r.start >= since]
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r.end - r.start)
    names = {k: {"count": len(v), "median_ms": _ms(v)}
             for k, v in sorted(by_name.items())}
    reads = {"sparsify_ms": _ms(by_name.get("runner.sparsify")),
             "fetch_wait_ms": _ms(by_name.get("runner.wait")),
             "dispatch_ms": _ms(by_name.get("runner.dispatch"))}
    host, sync = [], []
    for step in (r for r in recs if r.name == "train.step"):
        waited = sum(c.end - c.start for c in recs if c.parent is step
                     and c.name.startswith("train.sync"))
        host.append(step.end - step.start - waited)
        sync.append(waited)
    reads["step_host_ms"], reads["sync_wait_ms"] = _ms(host), _ms(sync)
    return names, {k: v for k, v in reads.items() if v is not None}


def idle_by_span(prof, torch) -> dict:
    """{innermost program span, or "none": idle device seconds} over
    the host stretch's window (lib/trace.py)."""
    from portbench.lib import trace
    from ubresnet_tpu_torch.utils.profiling import SPAN_PREFIX

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    win = [e for e in events if e.name == trace.WINDOW]
    if not win:
        return {}
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    busy = trace._merge([(s, min(e, w1)) for s, e, _ in
                         trace._device_ops(prof, torch, w0, w1)])
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type != cuda
                   and e.name.startswith(SPAN_PREFIX)
                   and w0 <= e.time_range.start < w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    totals = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inner = [n for s, e, n in spans if s <= mid <= e]
        label = inner[-1] if inner else "none"
        totals[label] = totals.get(label, 0.0) + (b - a) * 1e-6
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--record", type=int, choices=(0, 1), required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench.lib import common, harness, trace

    common.pin_caches()
    cell = common.load_cell(args.workload)
    import torch

    from ubresnet_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    made = []

    class Kept(trace.Stretch):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    trace.Stretch = Kept
    profiling.recording(bool(args.record))
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, T_START,
                              say=lambda m: None)
    profiling.recording(False)
    stretch = made[0]
    names, reads = span_reads(profiling.take(), stretch.quiet_from)
    idle = (idle_by_span(stretch.host_prof, torch)
            if stretch.host_prof is not None else {})
    result["device"]["power_limit"] = common.power_limit()
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "record": args.record, "trace": args.trace,
                      "result": result, "spans": names, "reads": reads,
                      "idle_by_span": idle}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
