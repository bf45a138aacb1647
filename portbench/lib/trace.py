"""The traced stretches of a ``--trace 1`` run and their reduction.

Two profiles cover the first calls of the window, one after the other:

* the device stretch, ``calls`` calls under torch.profiler with the CUDA
  activity only, which adds little to the host's cost of a launch: the
  device operations (kernels, copies, sets), the seconds in which any of
  them ran (``busy_s``, their union), the stretch's length on the host's
  clock from a synchronise before its first call to one after its last
  (``window_s``), launches and device seconds by kernel family (the name
  maps of ``kernels/*.json``) and the operations that took most time;
* the host stretch, ``label_calls`` more calls with the CPU activity
  too, each call in a ``portbench.<span>`` range the harness records:
  the device's idle gaps summed by what the host was doing at each gap's
  middle (the harness span and the innermost program op open then, on
  any thread: autograd's backward runs on its own). Recording every
  host op slows the host several-fold, so this stretch only names where
  idle time goes; its shares are not those of the device stretch.

The traces are read once the window has closed. Both profiles slow the
host (the CUDA-only one a score batch from about 33 to 42 ms), so the
harness's host-clock readings of a traced run (a batch's latency, the
rate behind ``mfu``) take only the calls made after both have closed
(``quiet_from``); the device stretch's idle share carries that cost.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional

WINDOW = "portbench.window"
SPAN = "portbench."


class Stretch:
    """Profile the window's first ``calls`` calls (device stretch), then
    ``label_calls`` more (host stretch); ``enabled`` False: a no-op.
    ``done`` counts the calls inside the device stretch; ``quiet_from``
    is the host's clock from which no profile runs (the window's start
    when not enabled, None while one runs)."""

    def __init__(self, torch, enabled: bool, calls: int,
                 label_calls: int = 0):
        self.torch = torch
        self.enabled = enabled
        self.calls = calls
        self.label_calls = label_calls
        self.done = 0
        self.seen = 0
        self.device_prof = self.host_prof = None
        self.window_s = 0.0
        self.quiet_from = None
        self._t0 = None
        self._window = None

    def start(self) -> None:
        """Before the window: the device profile starts."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self.device_prof = profile(activities=[ProfilerActivity.CUDA])
        self.device_prof.__enter__()

    def open(self) -> None:
        """The window opens."""
        if self.enabled:
            self.torch.cuda.synchronize()
            self._t0 = time.perf_counter()
        else:
            self.quiet_from = time.perf_counter()

    def quiet(self, t: float) -> bool:
        """Whether a call that started at ``t`` ran with no profile."""
        return self.quiet_from is not None and t >= self.quiet_from

    def span(self, name: str):
        """A harness span around one call while the host stretch runs."""
        if self._window is not None:
            return self.torch.profiler.record_function(SPAN + name)
        return contextlib.nullcontext()

    def called(self) -> None:
        """One more call of the window done."""
        if not self.enabled:
            return
        self.seen += 1
        if self._t0 is not None:
            self.done += 1
            if self.done >= self.calls:
                self._close_device()
        elif self._window is not None and (
                self.seen >= self.calls + self.label_calls):
            self._close_host()

    def _close_device(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._t0 = None
        self.device_prof.__exit__(None, None, None)
        if self.label_calls:
            self.host_prof = profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA])
            self.host_prof.__enter__()
            self._window = self.torch.profiler.record_function(WINDOW)
            self._window.__enter__()
        else:
            self.quiet_from = time.perf_counter()

    def _close_host(self) -> None:
        self.torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._window = None
        self.host_prof.__exit__(None, None, None)
        self.quiet_from = time.perf_counter()

    def finish(self) -> None:
        """At the window's end: close what is still open (a window with
        fewer calls than the stretches)."""
        if self._t0 is not None:
            self._close_device()
        if self._window is not None:
            self._close_host()


def _is_device_op(e, cuda_type) -> bool:
    if e.device_type != cuda_type:
        return False
    if getattr(e, "is_user_annotation", False):
        return False
    name = e.name
    return not (name.startswith(SPAN) or name.startswith("Optimizer.")
                or name.startswith("ProfilerStep"))


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def kernel_maps(bench_dir: Path) -> Dict[str, dict]:
    """{kernel family: its name map} from ``kernels/*.json``."""
    out = {}
    for p in sorted((bench_dir / "kernels").glob("*.json")):
        with open(p) as f:
            out[p.stem] = json.load(f)
    return out


def _family(name: str, maps: Dict[str, dict], key: str) -> Optional[str]:
    for fam, m in maps.items():
        if any(n in name for n in m.get(key, ())):
            return fam
    return None


def _device_ops(prof, torch, lo=None, hi=None):
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if _is_device_op(e, cuda)
                   and (lo is None or lo <= e.time_range.start < hi)),
                  key=lambda t: t[0])


def reduce(stretch: Stretch, torch, maps: Dict[str, dict]) -> dict:
    """What the readers need from both stretches (module docstring);
    empty where the device stretch saw no device operation."""
    if stretch.device_prof is None or not stretch.done:
        return {}
    ops = _device_ops(stretch.device_prof, torch)
    if not ops:
        return {}
    busy_s = sum(e - s for s, e in _merge([(s, e) for s, e, _ in ops])) * 1e-6
    # kernel families: a name map's ``names`` are the family's launches,
    # its ``extras`` belong to it wherever they run, its ``tails`` when
    # they follow one of its launches on the device
    fams: Dict[str, dict] = {}
    last = None
    for s, e, name in ops:
        fam = _family(name, maps, "names")
        counted = fam is not None
        if fam is None:
            fam = _family(name, maps, "extras")
        if fam is None and last is not None and any(
                n in name for n in maps[last].get("tails", ())):
            fam = last
        if fam is not None:
            f = fams.setdefault(fam, {"launches": 0, "device_s": 0.0})
            f["launches"] += int(counted)
            f["device_s"] += (e - s) * 1e-6
        last = fam if counted else None
    by_name: Dict[str, float] = {}
    for s, e, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": stretch.window_s, "busy_s": busy_s,
            "launches": len(ops), "calls": stretch.done, "families": fams,
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": (_idle_gaps(stretch.host_prof, torch)
                          if stretch.host_prof is not None else [])}


def _idle_gaps(prof, torch) -> List[list]:
    """The host stretch's idle device seconds summed by what the host
    was doing at each gap's middle; the 10 largest."""
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    win = [e for e in events if e.name == WINDOW]
    if not win:
        return []
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    merged = _merge([(s, min(e, w1)) for s, e, _ in
                     _device_ops(prof, torch, w0, w1)])
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type != cuda
                   and w0 <= e.time_range.start < w1
                   and e.name != WINDOW), key=lambda t: t[0])
    spans = [h for h in host if h[2].startswith(SPAN)]
    ops = [h for h in host if not h[2].startswith(SPAN)]
    span_starts = [h[0] for h in spans]
    op_starts = [h[0] for h in ops]
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    totals: Dict[str, float] = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(span_starts, mid) - 1
        span = (spans[i][2][len(SPAN):] if i >= 0 and spans[i][1] >= mid
                else "harness")
        op = None
        i = bisect.bisect_right(op_starts, mid) - 1
        for j in range(i, max(i - 4000, -1), -1):
            if ops[j][1] >= mid:
                op = ops[j][2]
                break
        label = span if op is None else f"{span} > {op}"
        totals[label] = totals.get(label, 0.0) + (b - a) * 1e-6
    return [[k[:160], v] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])[:10]]
