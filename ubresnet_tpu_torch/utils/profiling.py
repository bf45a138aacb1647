"""Tracing and profiling (counterpart of ubresnet_tpu/utils/profiling.py).

The reference instruments with per-stage cumulative timers printed at
exit (deploy/run_ubresnet_precropped.py:97-103) and wraps training in
torch.autograd.profiler (train_ubresnet2018_wlarcv2.py:51,209). Here:

  * StageTimer — the OrderedDict-of-cumulative-seconds pattern as a
    context-manager API, with the reference's per-event report format
  * trace — a torch.profiler run over the CPU and, where there is a
    card, CUDA activities, written as a Chrome trace (chrome://tracing,
    Perfetto)
  * span — a named range at a layer boundary of the port's runners and
    train step: ``ubresnet.<name>`` in whatever torch profile is active
    (so in ``trace``'s Chrome trace, beside the kernels it launched),
    and a ``SpanRecord`` on the host's ``time.perf_counter()`` while
    ``recording(True)`` is on; ``take()`` hands the records over. Off
    (no profile, no recording: the default) a span is one shared no-op
    object: no clock read, no allocation, no torch call.

On the card work is asynchronous: a wall-clock stage measures the
enqueue unless it ends in a device sync; ``sync=True`` waits for the
card when the stage's ``result`` is a CUDA tensor (nothing to wait for
on the CPU).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from typing import List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "ubresnet."


class SpanRecord:
    """One recorded span: ``name``; ``parent``, the innermost span open
    on the same thread when it opened (its record, or None); ``id``,
    the request it served (a batch's sequence number, a step's index),
    its parent's when not given; ``thread`` (``threading.get_ident``);
    ``start`` and ``end`` in seconds of ``time.perf_counter()``
    (``end`` None while the span is open)."""

    __slots__ = ("name", "parent", "id", "thread", "start", "end")

    def __init__(self, name, parent, id, thread, start):
        self.name, self.parent, self.id = name, parent, id
        self.thread, self.start, self.end = thread, start, None

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, id={self.id!r}, "
                f"start={self.start!r}, end={self.end!r})")


_recording = False
_records: List[SpanRecord] = []
_open = threading.local()  # .stack: this thread's open records


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "id", "_range", "_record")

    def __init__(self, name: str, id):
        self.name, self.id = name, id
        self._range = self._record = None

    def __enter__(self) -> Optional[SpanRecord]:
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(
                SPAN_PREFIX + self.name)
            self._range.__enter__()
        if _recording:
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            parent = stack[-1] if stack else None
            id = self.id
            if id is None and parent is not None:
                id = parent.id
            rec = SpanRecord(self.name, parent, id, threading.get_ident(),
                             time.perf_counter())
            stack.append(rec)
            _records.append(rec)
            self._record = rec
        return self._record

    def __exit__(self, *exc):
        rec = self._record
        if rec is not None:
            rec.end = time.perf_counter()
            _open.stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str, id=None):
    """A context manager around one layer boundary (module docstring);
    ``id`` names the request, inherited from the enclosing span when
    None. Entering gives the ``SpanRecord`` when recording, else None."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name, id)


def recording(on: bool) -> None:
    """Switch the in-memory span recorder on or off (off by default)."""
    global _recording
    _recording = bool(on)


def take() -> List[SpanRecord]:
    """The spans recorded so far, in the order they opened, and clear
    them (spans still open come with ``end`` None)."""
    out = list(_records)
    del _records[:len(out)]
    return out


class StageTimer:
    """Cumulative seconds and counts per stage on ``time.perf_counter()``
    and the reference's report. Each ``stage(name)`` also opens
    ``span(name)``, so a stage shows as ``ubresnet.<name>`` in a profile
    and as a record while recording is on (``run`` of
    deploy/precropped.py: ``read``, ``forward``, ``write``)."""

    def __init__(self):
        self.times: "OrderedDict[str, float]" = OrderedDict()
        self.counts: "OrderedDict[str, int]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str, result=None, sync: bool = False):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if (sync and isinstance(result, torch.Tensor)
                        and result.device.type == "cuda"):
                    torch.cuda.synchronize(result.device)
                self.times[name] = (self.times.get(name, 0.0)
                                    + time.perf_counter() - t0)
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
