"""Tracing and profiling (counterpart of ubresnet_tpu/utils/profiling.py).

The reference instruments with per-stage cumulative timers printed at
exit (deploy/run_ubresnet_precropped.py:97-103) and wraps training in
torch.autograd.profiler (train_ubresnet2018_wlarcv2.py:51,209). Here:

  * StageTimer — the OrderedDict-of-cumulative-seconds pattern as a
    context-manager API, with the reference's per-event report format
  * trace — a torch.profiler run over the CPU and, where there is a
    card, CUDA activities, written as a Chrome trace (chrome://tracing,
    Perfetto)

On the card work is asynchronous: a wall-clock stage measures the
enqueue unless it ends in a device sync; ``sync=True`` waits for the
card when the stage's ``result`` is a CUDA tensor (nothing to wait for
on the CPU).
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Optional

import torch


class StageTimer:
    def __init__(self):
        self.times: "OrderedDict[str, float]" = OrderedDict()
        self.counts: "OrderedDict[str, int]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str, result=None, sync: bool = False):
        t0 = time.time()
        try:
            yield
        finally:
            if (sync and isinstance(result, torch.Tensor)
                    and result.device.type == "cuda"):
                torch.cuda.synchronize(result.device)
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, n_events: Optional[int] = None) -> str:
        lines = ["------ timing -------"]
        for k, v in self.times.items():
            per = f" / {v / n_events:.5f} s per event" if n_events else ""
            lines.append(f"{k} : {v:.3f} s{per}")
        return "\n".join(lines)

    def as_dict(self) -> OrderedDict:
        return OrderedDict(self.times)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (the reference's RUNPROFILER
    block); on exit writes ``<log_dir>/trace.json``, a Chrome trace.
    CUDA activities are recorded when a card is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
