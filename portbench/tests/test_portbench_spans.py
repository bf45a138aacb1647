"""tools/spans.py's readings on hand-made span records, on the CPU: the
medians a batch or a step, a train step's host time without its two
device→host waits, only the spans that began at or after ``since``, and
nothing where no span of the kind was recorded."""
import pytest

from portbench.tools.spans import span_reads
from ubresnet_tpu_torch.utils.profiling import SpanRecord


def rec(name, start, end, parent=None, id=None):
    r = SpanRecord(name, parent, id, 1, start)
    r.end = end
    return r


def score_records():
    out = []
    for i, (sp, wait) in enumerate([(0.004, 0.001), (0.006, 0.003),
                                    (0.010, 0.002)]):
        t = 10.0 * i
        d = rec("runner.dispatch", t, t + 0.020, id=i)
        f = rec("runner.fetch", t + 1, t + 1.005, id=i)
        out += [d, rec("runner.sparsify", t, t + sp, d, i), f,
                rec("runner.wait", t + 1, t + 1 + wait, f, i)]
    return out


def train_records():
    out = []
    for i, (total, guard, scalars) in enumerate([(0.100, 0.010, 0.002),
                                                 (0.120, 0.030, 0.004),
                                                 (0.110, 0.020, 0.001)]):
        t = 10.0 * i
        s = rec("train.step", t, t + total, id=i)
        out += [s, rec("train.forward", t, t + 0.03, s, i),
                rec("train.sync.guard", t + 0.05, t + 0.05 + guard, s, i),
                rec("train.sync.scalars", t + 0.09, t + 0.09 + scalars,
                    s, i)]
    return out


def test_score_reads():
    names, reads = span_reads(score_records(), since=0.0)
    assert reads == pytest.approx({"sparsify_ms": 6.0, "fetch_wait_ms": 2.0,
                                   "dispatch_ms": 20.0})
    assert names["runner.wait"]["count"] == 3


def test_train_reads():
    _, reads = span_reads(train_records(), since=0.0)
    # host: 0.088, 0.086, 0.089; waits: 0.012, 0.034, 0.021
    assert reads == pytest.approx({"step_host_ms": 88.0,
                                   "sync_wait_ms": 21.0})


def test_reads_only_after_since_and_none_without_spans():
    _, reads = span_reads(score_records(), since=5.0)
    assert reads["sparsify_ms"] == pytest.approx(8.0)
    assert span_reads([], since=0.0) == ({}, {})
    assert span_reads(score_records(), since=100.0) == ({}, {})
    assert "step_host_ms" not in span_reads(score_records(), 0.0)[1]
