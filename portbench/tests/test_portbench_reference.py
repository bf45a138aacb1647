"""The plain reference (portbench/reference) held to the port's CPU path
at a small size: the eval scores, the training loss, gradients and
running statistics, and Adam's update; the benchmark's weights give
scores that are not saturated, and are drawn bit for bit as they were
before a configuration's ``arch`` picked the reference.

    python -m pytest portbench/tests -q
"""
import math

import numpy as np
import pytest
import torch

from portbench.lib import common, synth
from portbench.reference import shared
from portbench.reference import uresnet as ref
from portbench.reference import weights
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.models import get_model

GEN = {"n_tracks": [1, 4], "n_showers": [0, 3], "adc_noise": 0.5,
       "noise_occupancy": 0.005, "vertex_weight": 10.0}


def config(inplanes):
    return {"arch": "uresnet", "inplanes": inplanes, "depth": 5,
            "num_classes": 3, "input_channels": 1, "final_conv_kernels": 16}


def make(inplanes=16, hw=(64, 64), n=4, seed=3):
    rng = np.random.RandomState(seed)
    cal = torch.from_numpy(synth.crops(rng, 12, hw, GEN)["image"])
    sd = weights.make_state_dict(config(inplanes), seed, "cpu", cal)
    return sd, synth.crops(rng, n, hw, GEN)


@pytest.mark.parametrize("inplanes", [16, 32])
def test_scores_match_the_port_f32(inplanes):
    sd, b = make(inplanes)
    x = torch.from_numpy(b["image"])
    want = ref.probabilities(sd, x, chunk=2)
    model = get_model("uresnet", {k: v.clone() for k, v in sd.items()},
                      policy=Policy.f32(), device="cpu")
    with torch.no_grad():
        got = torch.exp(model(x))
    assert float((got - want).abs().max()) < 1e-4


def test_scores_are_not_saturated():
    sd, b = make()
    p = ref.probabilities(sd, torch.from_numpy(b["image"]))
    assert torch.allclose(p.sum(-1), torch.ones(()), atol=1e-5)
    # most pixels keep every class's probability away from 0 and 1
    inside = ((p > 1e-4) & (p < 1 - 1e-4)).all(-1).float().mean()
    assert float(inside) > 0.9
    saturated = ((p < 1e-6) | (p > 1 - 1e-6)).float().mean()
    assert float(saturated) < 0.05


def test_weights_follow_the_seed():
    a, _ = make(seed=5)
    b, _ = make(seed=5)
    c, _ = make(seed=6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.weight"], c["conv1.weight"])
    w = a["enc_layer2.res1.conv1.weight"]
    std = math.sqrt(2.0 / (9 * w.shape[0]))
    assert abs(float(w.std()) / std - 1) < 0.05


# The configurations' weights at 2**31 + 5 with 4 calibration crops of
# 64x64, taken before the reference was looked up by ``arch``: the count
# of tensors, the float64 sum of the drawn tensors (conv weights and
# biases, BN weights and biases) and that sum weighted by the place in
# the state_dict, then the same two sums of the running statistics. The
# draws are exact; the running statistics come from the CPU's float32
# convolutions, whose order of summation follows the thread count (the
# sums move in the 10th digit), so they are held to 1e-8.
PINNED = {"uresnet16": (269, 7379.537364122869, 806397.7307347292,
                        10833.85740156006, 587721.9964230284),
          "uresnet32": (269, 14638.99820809835, 1608844.8448914115,
                        22223.778331717476, 1212797.7820507307)}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_weights_are_drawn_as_pinned(name):
    cfg = common.load_json(common.BENCH_DIR / "configs" / f"{name}.json")
    rng = np.random.RandomState(7)
    cal = torch.from_numpy(synth.crops(rng, 4, (64, 64), GEN)["image"])
    sd = weights.make_state_dict(cfg, 2 ** 31 + 5, "cpu", cal)

    def sums(keys):
        s = [float(sd[k].double().numpy().sum()) for k in keys]
        return (math.fsum(s),
                math.fsum((i + 1) * v for i, v in enumerate(s)))

    n, draw, draw_w, stat, stat_w = PINNED[name]
    assert len(sd) == n
    assert sums([k for k in sd if ref.is_param(k)]) == (draw, draw_w)
    got = sums([k for k in sd if not ref.is_param(k)])
    assert got == pytest.approx((stat, stat_w), rel=1e-8)


def _port_step(sd, batches, lr, wd):
    from ubresnet_tpu_torch.train.optimizers import make_optimizer
    from ubresnet_tpu_torch.train.step import (build_train_step,
                                               create_train_state)

    model = get_model("uresnet", {k: v.clone() for k, v in sd.items()},
                      policy=Policy.f32(), device="cpu", train=True)
    opt = make_optimizer(model.parameters(), "adam", learning_rate=lr,
                         weight_decay=wd)
    state = create_train_state(model, opt)
    step = build_train_step(num_classes=3, device="cpu")
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(m["loss"])
    return model, losses


def test_training_steps_match_the_port_f32():
    sd, b = make(n=4)
    batches = [{k: v[i:i + 2] for k, v in b.items()} for i in (0, 2)]
    for x in batches:
        x["label"] = x["label"].astype(np.int32)
    lr, wd = 1e-5, 1e-4  # the configurations' Adam
    feed = [{k: torch.from_numpy(v) for k, v in x.items()} for x in batches]
    # one step: the running statistics element by element
    out = ref.train_steps(sd, feed[:1], lr, wd)
    model, losses = _port_step(sd, batches[:1], lr, wd)
    got = model.state_dict()
    for k, v in out["sd"].items():
        if not ref.is_param(k):
            moved = float((v - sd[k]).abs().max())
            gap = float((got[k].float() - v).abs().max())
            assert gap <= 1e-4 * moved + 1e-7, k
    # two steps: the losses; every leaf by the norm of its change. Adam's
    # first step moves each element by about lr·sign(g), and where g is
    # rounding noise the sign is either's: element by element the two
    # differ by 2·lr there. Leaves whose gradient is all rounding (the
    # conv biases a BatchNorm follows) are left out.
    out = ref.train_steps(sd, feed, lr, wd)
    model, losses = _port_step(sd, batches, lr, wd)
    assert np.allclose(losses, out["losses"], rtol=1e-4)
    got = model.state_dict()
    med = float(np.median(list(out["raw_grad1"].values())))
    for k, v in out["sd"].items():
        if ref.is_param(k) and out["raw_grad1"][k] < 1e-3 * med:
            continue
        want = float((v - sd[k]).norm())
        have = float((got[k].float() - sd[k]).norm())
        assert abs(have - want) <= 0.02 * want + 1e-7, k


def test_adam_is_torch_adam():
    torch.manual_seed(0)
    p = torch.randn(5, 3)
    grads = [torch.randn(5, 3) for _ in range(3)]
    mine = shared.Adam(1e-2, 1e-3)
    q = {"w": p.clone()}
    for g in grads:
        q = mine.step(q, {"w": g})
    t = p.clone().requires_grad_(True)
    opt = torch.optim.Adam([t], lr=1e-2, weight_decay=1e-3)
    for g in grads:
        t.grad = g.clone()
        opt.step()
    assert torch.allclose(q["w"], t.detach(), atol=1e-7)


def test_fp8_control_rounds():
    x = torch.linspace(-3, 3, 101)
    q = shared.fp8_round(x)
    assert float((q - x).abs().max()) > 1e-3
    assert float((q - x).abs().max()) < 0.07 * 3
