"""The benchmark's plain ASPP-ResNet (portbench/reference/aspp_resnet.py)
against the port's ASPPResNet, the ``model.aspp`` spans, and the
``offzone_ms.score`` reader, on the CPU.

The reference is held to the port's float32 policy at 64x64 and
inplanes 16 on the benchmark's own seeded, calibrated weights, to the
bound portbench/tests/test_portbench_reference.py holds UResNet to
(|Δp| < 1e-4) with identical argmax; its layout is the port's seeded
ASPP state_dict's, key for key and shape for shape; its FLOP count is
the one the benchmark's ``mfu.score`` reads for the ``aspp16``
configuration."""
import json

import numpy as np
import pytest
import torch

from portbench.lib import common, synth
from portbench.reference import aspp_resnet as ref
from portbench.reference import weights
from portbench.work import arith
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.precropped import PrecroppedRunner
from ubresnet_tpu_torch.deploy.weights import random_state_dict
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.parallel.sharding import row_split
from ubresnet_tpu_torch.utils.profiling import recording, take

torch.set_num_threads(1)

HW = (64, 64)
GEN = json.loads((common.BENCH_DIR / "traffic" / "score_512_b16.json")
                 .read_text())["generator"]
MACS_512 = 51_824_820_224


def aspp16():
    return common.load_json(common.BENCH_DIR / "configs" / "aspp16.json")


@pytest.fixture(scope="module")
def made():
    """The benchmark's weights of ``aspp16`` at 64x64 and four crops."""
    rng = np.random.RandomState(3)
    cal = torch.from_numpy(synth.crops(rng, 12, HW, GEN)["image"])
    sd = weights.make_state_dict(aspp16(), 2 ** 31 + 3, "cpu", cal)
    return sd, torch.from_numpy(synth.crops(rng, 4, HW, GEN)["image"])


@pytest.fixture(scope="module")
def want(made):
    sd, x = made
    return ref.probabilities(sd, x, chunk=2)


def test_scores_match_the_port_f32(made, want):
    sd, x = made
    model = get_model("aspp_resnet", {k: v.clone() for k, v in sd.items()},
                      policy=Policy.f32(), device="cpu")
    with torch.no_grad():
        got = torch.exp(model(x))
    assert float((got - want).abs().max()) < 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_scores_are_not_saturated(want):
    assert torch.allclose(want.sum(-1), torch.ones(()), atol=1e-5)
    inside = ((want > 1e-4) & (want < 1 - 1e-4)).all(-1).float().mean()
    assert float(inside) > 0.9
    saturated = ((want < 1e-6) | (want > 1 - 1e-6)).float().mean()
    assert float(saturated) < 0.05


def test_layout_is_the_ports_state_dict():
    convs, biases, bns = ref.layout(aspp16())
    shapes = {k: tuple(s) for k, s, _ in convs}
    for k, _ in biases:
        shapes[k] = (shapes[k.replace(".bias", ".weight")][0],)
    for k, c in bns:
        for p in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{k}.{p}"] = (c,)
    port = random_state_dict(arch="aspp_resnet")
    assert len(port) == len(shapes) == 359
    assert {k: tuple(v.shape) for k, v in port.items()} == shapes


@pytest.mark.parametrize("hw,macs", [((512, 512), MACS_512),
                                     ((64, 64), MACS_512 // 64)])
def test_forward_macs(hw, macs):
    assert arith.forward_macs(aspp16(), hw) == macs


def test_dilated_branches_reach_their_dilation():
    """A branch at dilation d reads the feature d pixels from the centre
    and keeps its size: a single lit pixel of e moves the outputs at
    offsets 0 and ±d only (BN biased far above 0, so ReLU clips
    nothing)."""
    sd = weights.make_state_dict(aspp16(), 9, "cpu",
                                 torch.rand(2, 64, 64, 1))
    e = torch.zeros(1, 128, 9, 9)   # enc3's width at inplanes 16
    e[0, :, 4, 4] = 1.0
    for b, _, d in ref.BRANCHES:
        bn = f"ASPP_layer_enc3.{b}_bn"
        sd[f"{bn}.bias"] = torch.full((16,), 1e3)
        net = ref.Net(sd)
        key = f"ASPP_layer_enc3.{b}_conv"
        y = (net.conv_bn_relu(e, key, bn, d)
             - net.conv_bn_relu(torch.zeros_like(e), key, bn, d))
        assert y.shape == (1, 16, 9, 9)
        lit = (y.abs().sum(1)[0] > 0).nonzero().tolist()
        moved = {tuple(p) for p in lit}
        reach = [4] if b == "B1" else [4 - d, 4, 4 + d]
        assert moved == {(r, c) for r in reach for c in reach
                         if 0 <= r < 9 and 0 <= c < 9}, b


# ----------------------------------------------------------------- spans


@pytest.fixture
def recorder():
    recording(False)
    take()
    yield
    recording(False)
    take()


def _crops(b=2, seed=3):
    return synth.crops(np.random.RandomState(seed), b, HW,
                       GEN)["image"].astype(np.float32)


def _aspp_spans(records):
    return [r for r in records if r.name == "model.aspp"]


@pytest.mark.parametrize("arch", ["aspp_resnet", "uresnet"])
def test_runner_batch_records_the_aspp_spans(recorder, arch):
    model = get_model(arch, random_state_dict(seed=4, arch=arch),
                      policy=Policy.f32(), device="cpu")
    runner = PrecroppedRunner(model, batch_size=2)
    x = _crops()
    runner._fetch(runner._dispatch(x), 2, HW)   # batch 1, not recorded
    recording(True)
    runner._fetch(runner._dispatch(x), 2, HW)
    records = take()
    spans = _aspp_spans(records)
    if arch == "uresnet":
        assert spans == []
        return
    assert [r.id for r in spans] == [3, 4, 5]
    for r in spans:
        assert r.parent is not None and r.parent.name == "runner.forward"
        assert r.parent.id == 2
        assert r.parent.start <= r.start <= r.end <= r.parent.end
    assert spans[0].end <= spans[1].start and spans[1].end <= spans[2].start


def test_row_slabs_and_train_forward_record_the_aspp_spans(recorder):
    sd = random_state_dict(seed=4, arch="aspp_resnet")
    x = torch.from_numpy(_crops())
    model = get_model("aspp_resnet", sd, policy=Policy.f32(), device="cpu")
    recording(True)
    with torch.no_grad():
        model.forward_rows(row_split(x, [torch.device("cpu")] * 2))
    spans = take()
    # one span a stage over both slabs
    assert [r.name for r in spans] == ["model.aspp"] * 3
    assert [r.id for r in spans] == [3, 4, 5]
    train = get_model("aspp_resnet", sd, policy=Policy.f32(), device="cpu",
                      train=True)
    train(x).sum().backward()
    spans = take()
    assert [(r.name, r.id) for r in spans] == [("model.aspp", i)
                                               for i in (3, 4, 5)]


def test_aspp_spans_change_no_score(recorder):
    sd = random_state_dict(seed=4, arch="aspp_resnet")
    x = torch.from_numpy(_crops())
    model = get_model("aspp_resnet", sd, policy=Policy.f32(), device="cpu")
    with torch.no_grad():
        off = model(x)
        recording(True)
        on = model(x)
    assert torch.equal(off, on)
    assert len(_aspp_spans(take())) == 3


# ------------------------------------------------------ offzone_ms.score


def _offzone():
    return common.load_module(common.BENCH_DIR / "metrics"
                              / "offzone_ms.score.py")


def test_offzone_reads_busy_time_outside_the_families():
    read = _offzone().read
    fams = {"basic_block": {"launches": 60, "device_s": 0.050},
            "deconv2x": {"launches": 20, "device_s": 0.010},
            "conv_bn_act": {"launches": 20, "device_s": 0.020}}
    ctx = {"trace": {"busy_s": 0.200, "window_s": 0.300, "calls": 10,
                     "families": fams}}
    assert read(ctx) == pytest.approx(12.0)   # (0.200 - 0.080) / 10 s
    ctx["trace"]["families"] = {}
    assert read(ctx) == pytest.approx(20.0)


def test_offzone_reads_nothing_without_a_trace():
    read = _offzone().read
    assert read({"trace": {}}) is None
    assert read({"trace": {"busy_s": 0.1, "calls": 0, "families": {}}}) \
        is None
