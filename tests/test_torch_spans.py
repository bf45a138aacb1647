"""The port's spans (utils/profiling.py:span): off, a span is one shared
no-op that reads no clock and makes no torch call; recording, the deploy
runner's dispatch and fetch and the train step leave the records their
docstrings name, nested, with one id a batch or step; under a torch
profile the same ranges appear as ``ubresnet.<name>``, nested as the
records are; and neither changes a score or a step's result. Float32 on
the CPU, the flagship width at 64x64."""
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.deploy.precropped import PrecroppedRunner
from ubresnet_tpu_torch.deploy.weights import random_state_dict
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.ops.sparse import sparsify_batch
from ubresnet_tpu_torch.train.optimizers import make_optimizer
from ubresnet_tpu_torch.train.step import build_train_step, create_train_state
from ubresnet_tpu_torch.utils import profiling
from ubresnet_tpu_torch.utils.profiling import (
    SPAN_PREFIX,
    StageTimer,
    recording,
    span,
    take,
)

torch.set_num_threads(1)

HW = (64, 64)
B = 2


@pytest.fixture(autouse=True)
def recorder_off():
    recording(False)
    take()
    yield
    recording(False)
    take()


@pytest.fixture(scope="module")
def state_dict():
    return random_state_dict(seed=5)


def _crops(seed=3, b=B):
    rng = np.random.RandomState(seed)
    x = np.zeros((b,) + HW + (1,), np.float32)
    for i in range(b):
        r, c = rng.randint(0, HW[0], 200), rng.randint(0, HW[1], 200)
        x[i, r, c, 0] = rng.uniform(10, 200, 200)
    return x


def _train_batch(seed=4):
    img = _crops(seed)
    label = np.where(img[..., 0] > 100, 2, (img[..., 0] > 0).astype(int))
    weight = np.where(img[..., 0] > 0, 3.0, 0.5).astype(np.float32)
    sp = sparsify_batch({"image": img, "label": label.astype(np.int32),
                         "weight": weight})
    sp.pop("hw")
    return sp


def _runner(state_dict, **kw):
    model = get_model("uresnet", state_dict, policy=Policy.f32(),
                      device="cpu")
    return PrecroppedRunner(model, batch_size=B, **kw)


def _step(state_dict, accum_steps=1):
    model = get_model("uresnet", state_dict, policy=Policy.f32(),
                      device="cpu", train=True)
    opt = make_optimizer(model.parameters(), "adam", learning_rate=1e-3)
    step = build_train_step(sparse_hw=HW, accum_steps=accum_steps,
                            device="cpu")
    return create_train_state(model, opt), step


def _children(records, parent):
    return [r.name for r in records if r.parent is parent]


def _one(records, name):
    found = [r for r in records if r.name == name]
    assert len(found) == 1, [r.name for r in records]
    return found[0]


def _raise(*args, **kwargs):
    raise AssertionError("the off path reached a clock or torch")


@pytest.mark.parametrize("how", ["span", "stage"])
def test_off_span_is_a_shared_noop(monkeypatch, how):
    """Off, ``span`` hands out one object, reads no clock, opens no
    torch range and records nothing; a StageTimer stage still times."""
    timer = StageTimer()
    with monkeypatch.context() as m:
        m.setattr(torch.autograd.profiler, "record_function", _raise)
        m.setattr(torch.profiler, "record_function", _raise)
        m.setattr(profiling.SpanRecord, "__init__", _raise)
        if how == "span":
            m.setattr(profiling, "time", types.SimpleNamespace(
                perf_counter=_raise))
            first, second = span("a"), span("b", id=7)
            assert first is second is profiling._NO_SPAN
            with first as got:
                assert got is None
        else:
            with timer.stage("read"):
                pass
    assert take() == []
    if how == "stage":
        assert timer.counts == {"read": 1}


def test_recorder_nests_inherits_ids_and_keeps_threads_apart():
    recording(True)
    seen = {}

    def worker():
        with span("w") as rec:
            seen["w"] = rec

    with span("outer", id=3) as outer:
        with span("inner") as inner:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        with span("other", id=9) as other:
            pass
    recording(False)
    with span("after"):
        pass
    records = take()
    assert [r.name for r in records] == ["outer", "inner", "w", "other"]
    assert inner.parent is outer and other.parent is outer
    assert outer.parent is None and seen["w"].parent is None
    assert (outer.id, inner.id, other.id, seen["w"].id) == (3, 3, 9, None)
    assert seen["w"].thread != outer.thread == threading.get_ident()
    assert outer.start <= inner.start <= inner.end <= other.start
    assert other.end <= outer.end
    assert take() == []


@pytest.mark.parametrize("mode", [
    dict(), dict(compact_readback="sparse"), dict(sparse=False),
    dict(compact_readback="u8")], ids=["sparse", "sparse_readback", "dense",
                                       "u8"])
def test_runner_spans(state_dict, mode):
    if mode.get("compact_readback") == "sparse":
        with pytest.warns(UserWarning):
            runner = _runner(state_dict, **mode)
    else:
        runner = _runner(state_dict, **mode)
    x = _crops()
    runner._fetch(runner._dispatch(x), B, HW)  # batch 1, not recorded
    recording(True)
    runner._fetch(runner._dispatch(x), B, HW)
    records = take()
    dispatch, fetch = _one(records, "runner.dispatch"), _one(records,
                                                             "runner.fetch")
    want = (["runner.sparsify"] if runner.sparse else []) + (
        ["runner.halo"] if runner.compact == "sparse" else []) + [
        "runner.stage", "runner.forward", "runner.readback"]
    assert _children(records, dispatch) == want
    assert _children(records, fetch) == ["runner.wait"]
    assert dispatch.parent is None and fetch.parent is None
    assert {r.id for r in records} == {2}
    for r in records:
        assert r.end is not None and r.start <= r.end
        if r.parent is not None:
            assert r.parent.start <= r.start and r.end <= r.parent.end
    assert dispatch.end <= fetch.start


def test_run_stages_are_spans(state_dict, tmp_path):
    """``run``'s StageTimer: ``read``, ``forward`` around each dispatch
    and drain, ``write`` on the writer thread; the timing keys and
    their order are unchanged."""
    src = make_synthetic_file(str(tmp_path / "in.uevt"), n_events=3, hw=HW)
    runner = _runner(state_dict)
    recording(True)
    timing = runner.run(src, str(tmp_path / "out.uevt"))
    records = take()
    assert list(timing) == ["total", "read", "forward", "write"]
    assert all(v > 0 for v in timing.values())
    top = [r.name for r in records if r.parent is None]
    assert top.count("write") == 2 and top.count("read") == 3
    assert top.count("forward") == 4   # two dispatches and two drains
    for r in records:
        if r.name == "runner.dispatch":
            assert r.parent.name == "forward" and r.id in (1, 2)
        if r.name == "write":
            assert r.thread != threading.get_ident()


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_spans(state_dict, accum_steps):
    state, step = _step(state_dict, accum_steps)
    batch = _train_batch()
    state, _ = step(state, batch)
    recording(True)
    state, _ = step(state, batch)
    records = take()
    top = _one(records, "train.step")
    assert top.parent is None and {r.id for r in records} == {1}
    micro = ["train.forward", "train.loss", "train.backward"] * accum_steps
    assert _children(records, top) == [
        "train.h2d", "train.densify", "train.bn_save", *micro,
        "train.sync.guard", "train.optimizer", "train.sync.scalars"]
    assert sum(r.name.startswith("train.sync") for r in records) == 2
    kids = [r for r in records if r.parent is top]
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start
    assert top.start <= kids[0].start and kids[-1].end <= top.end


def _nested(events):
    """(name, parent name) of the profile's ``ubresnet.*`` ranges, by
    the innermost range that contains each."""
    ev = sorted(((e.time_range.start, -e.time_range.end, e.name)
                 for e in events if e.name.startswith(SPAN_PREFIX)))
    out, open_ = [], []
    for s, neg_end, name in ev:
        while open_ and open_[-1][1] < s:
            open_.pop()
        out.append((name[len(SPAN_PREFIX):],
                    open_[-1][0][len(SPAN_PREFIX):] if open_ else None))
        open_.append((name, -neg_end))
    return out


@pytest.mark.parametrize("what", ["runner", "train"])
def test_profile_ranges_nest_as_records(state_dict, what):
    if what == "runner":
        runner = _runner(state_dict)
        x = _crops()

        def call():
            runner._fetch(runner._dispatch(x), B, HW)
    else:
        state, step = _step(state_dict)
        batch = _train_batch()

        def call():
            step(state, batch)
    call()
    recording(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    records = take()
    want = [(r.name, r.parent.name if r.parent else None) for r in records]
    assert len(want) >= 6
    assert _nested(prof.events()) == want


@pytest.mark.parametrize("what", ["runner", "train"])
def test_recording_changes_no_result(state_dict, what):
    outs = []
    for on in (False, True):
        recording(on)
        if what == "runner":
            runner = _runner(state_dict)
            outs.append([runner._fetch(runner._dispatch(_crops(s)), B, HW)
                         for s in (3, 8)])
        else:
            state, step = _step(state_dict)
            metrics = [step(state, _train_batch(s))[1] for s in (4, 9)]
            outs.append((metrics, {k: v.detach().clone() for k, v in
                                   state.model.state_dict().items()}))
    assert len(take()) > 0
    if what == "runner":
        for a, b in zip(*outs):
            assert np.array_equal(a, b)
    else:
        (m0, sd0), (m1, sd1) = outs
        assert m0 == m1
        assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
