"""Training in the port (ubresnet_tpu_torch: TrainUResNet, the train
step, optimizers, sparse batches) against the JAX package, float32 on
the CPU, flagship width (inplanes 16) at 64x64, batch 2.

Weights: one seeded reference state_dict; JAX imports it
(deploy/importers.py) and the port takes the JAX variables back through
``state_dict_from_jax``. Tolerances, with what sets them:
  * train-mode BN makes f32 rounding matter more than in eval: on this
    batch JAX's own f32 logits are 2.8e-5·max|logit| and its running
    stats 1.4e-5·max|stat| away from the same network evaluated in
    float64 (the port's modules in f64), the port's 1.1e-5 and 3.9e-6.
    So the port's logits must be within 2e-5·max of the f64 evaluation
    and 1e-4·max of JAX's, its running stats within 1e-5·max of f64
    and 5e-5·max of JAX's, the loss at rtol 1e-5;
  * every parameter gradient within 5e-2 of the global max |grad| —
    the JAX package's own floor for f32 BN-train gradients at model
    level (tests/test_pallas_conv.py:262-281, docs/roofline.md:242-247);
    measured here: JAX 1.0e-2 and the port 1.1e-2 from f64, 1.6e-2
    apart;
  * after one SGD step (lr 1e-2), parameters within lr·5e-2·max|grad|
    of JAX's (the gradient floor through the update), running stats
    within 5e-5·max, the loss at rtol 1e-5 and every metric within
    1e-6;
  * optimizers fed the same numpy gradients at rtol 1e-6, atol 1e-6
    (the absolute floor of tests/test_train.py:107, which holds optax
    against torch.optim the same way)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import import_uresnet_state_dict
from ubresnet_tpu.losses import pixelwise_weighted_nll_from_logits as jax_nll
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu.ops import sparse as jax_sparse
from ubresnet_tpu.parity.torch_oracle import make_state_dict
from ubresnet_tpu.train import optimizers as jax_opt
from ubresnet_tpu.train import schedules as jax_sched
from ubresnet_tpu.train import step as jax_step
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import state_dict_from_jax
from ubresnet_tpu_torch.losses import pixelwise_weighted_nll_from_logits
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import loss as loss_ops
from ubresnet_tpu_torch.ops import pool as pool_ops
from ubresnet_tpu_torch.ops import sparse as port_sparse
from ubresnet_tpu_torch.ops import train_conv as train_ops
from ubresnet_tpu_torch.ops.loss import weighted_nll
from ubresnet_tpu_torch.train import optimizers as port_opt
from ubresnet_tpu_torch.train import schedules as port_sched
from ubresnet_tpu_torch.train.step import build_train_step, create_train_state

torch.set_num_threads(1)

F32 = Policy.f32()
F32_ZONE = dataclasses.replace(Policy.f32(), fused_train=True)
LR = 1e-2
GRAD_FLOOR = 5e-2


@pytest.fixture(scope="module")
def variables():
    sd = make_state_dict(np.random.RandomState(0), inplanes=16)
    return import_uresnet_state_dict({k: v.numpy() for k, v in sd.items()})


def _batch(seed, b=2, hw=64):
    """Sparse ADC-like crop with class labels on the hits and class-
    balancing-like weights (a background level plus hit weights)."""
    rng = np.random.RandomState(seed)
    img = np.zeros((b, hw, hw, 1), np.float32)
    lab = np.zeros((b, hw, hw), np.int32)
    wgt = np.full((b, hw, hw), 0.4, np.float32)
    for i in range(b):
        n = 300
        ys, xs = rng.randint(0, hw, n), rng.randint(0, hw, n)
        img[i, ys, xs, 0] = rng.rand(n) * 50 + 5
        lab[i, ys, xs] = rng.randint(1, 3, n)
        wgt[i, ys, xs] = rng.rand(n) * 5 + 1
    return {"image": img, "label": lab, "weight": wgt}


def _jax_model():
    return jax_get_model("uresnet", policy=JaxPolicy.f32(), input_channels=1,
                         inplanes=16)


def _state_dict(variables, grads=None, stats=None):
    """Reference-keyed tensors of JAX params (or grads) and stats."""
    return state_dict_from_jax({
        "params": variables["params"] if grads is None else grads,
        "batch_stats": variables["batch_stats"] if stats is None else stats})


def _assert_stats(got_sd, want_sd, tol):
    """Every running stat within ``tol``·max|stat| of its tensor."""
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        want = want_sd[k].double()
        err = float((got_sd[k].double() - want).abs().max())
        assert err <= tol * float(want.abs().max()), (k, err)


@pytest.fixture(scope="module")
def jax_train_forward(variables):
    """JAX logits, running stats and loss gradients of one train-mode
    forward+backward (Policy.f32, pixel-weighted NLL)."""
    batch = _batch(1)
    model = _jax_model()

    @jax.jit
    def run(params):
        def loss(p):
            out, upd = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                jnp.asarray(batch["image"]), train=True, logits=True,
                mutable=["batch_stats"])
            return jax_nll(out, batch["label"], batch["weight"]), (out, upd)

        return jax.value_and_grad(loss, has_aux=True)(params)

    (loss, (logits, upd)), grads = run(variables["params"])
    return batch, float(loss), np.array(logits), _state_dict(
        variables, grads=grads, stats=upd["batch_stats"])


@pytest.mark.parametrize("policy", [F32, F32_ZONE], ids=["plain", "zone"])
def test_train_forward_backward_matches_jax(variables, jax_train_forward,
                                            policy):
    """Train-mode logits, BN running-stat updates and every parameter
    gradient ≡ JAX; the zone form runs the kernels' plain versions (K5,
    conv_ad, the pool AD) and the loss kernel's."""
    batch, want_loss, want_logits, want = jax_train_forward
    model = get_model("uresnet", state_dict_from_jax(variables),
                      policy=policy, device="cpu", train=True)
    assert sum(m.zone for m in model.modules() if hasattr(m, "zone")) == (
        17 if policy.fused_train else 0)
    logits = model(torch.from_numpy(batch["image"]), logits=True)
    lab, wgt = torch.from_numpy(batch["label"]), torch.from_numpy(
        batch["weight"])
    loss = (weighted_nll(logits, lab, wgt) if policy.fused_train
            else pixelwise_weighted_nll_from_logits(logits, lab, wgt))
    loss.backward()
    f64 = Policy(compute_dtype=torch.float64, output_dtype=torch.float64,
                 fused_eval=False, fused_train=False)
    exact = get_model("uresnet", state_dict_from_jax(variables), policy=f64,
                      device="cpu", train=True).double()
    with torch.no_grad():
        ref = exact(torch.from_numpy(batch["image"]).double(), logits=True)
    got = logits.detach().double()
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 2e-5 * scale
    assert float((got - torch.from_numpy(want_logits).double()).abs()
                 .max()) <= 1e-4 * scale
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    _assert_stats(model.state_dict(), exact.state_dict(), 1e-5)
    _assert_stats(model.state_dict(), want, 5e-5)
    grads = dict(model.named_parameters())
    assert set(grads) == {k for k in want if not k.endswith(
        ("running_mean", "running_var"))}
    gsc = max(float(want[k].abs().max()) for k in grads)
    for k, p in grads.items():
        err = float((p.grad - want[k]).abs().max())
        assert err < GRAD_FLOOR * gsc, (k, err, gsc)


def _jax_sgd_state(variables, model):
    tx = jax_opt.make_optimizer("sgd", learning_rate=LR, weight_decay=1e-3,
                                momentum=0.9)
    return jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        best_metric=jnp.zeros((), jnp.float32),
        nan_count=jnp.zeros((), jnp.int32), apply_fn=model.apply, tx=tx)


_JAX_STEPS = {}


def _jax_step_result(variables, mode):
    """JAX's new state and metrics after one SGD step (cached per
    transfer form: each is one XLA compile). The sparse form's is the
    dense form's: JAX's sparse transfer densifies back to the same batch
    on the device (ubresnet_tpu/ops/sparse.py), and its step's result
    is the dense step's bit for bit."""
    if mode == "sparse":
        mode = "dense"
    if mode not in _JAX_STEPS:
        batch = _batch(2)
        kw = dict(num_classes=3, donate=False)
        if mode == "accum2":
            kw["accum_steps"] = 2
        state = _jax_sgd_state(variables, _jax_model())
        new, metrics = jax_step.build_train_step(**kw)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        _JAX_STEPS[mode] = (
            _state_dict({"params": new.params,
                         "batch_stats": new.batch_stats}),
            {k: float(v) for k, v in metrics.items()})
    return _JAX_STEPS[mode]


@pytest.mark.parametrize("mode,policy", [("dense", F32), ("dense", F32_ZONE),
                                         ("sparse", F32), ("accum2", F32)],
                         ids=["dense", "dense-zone", "sparse", "accum2"])
def test_sgd_train_step_matches_jax(variables, mode, policy):
    want_sd, want_m = _jax_step_result(variables, mode)
    batch = _batch(2)
    kw = dict(num_classes=3, use_pallas_loss=policy.fused_train,
              device="cpu")
    if mode == "sparse":
        batch = port_sparse.sparsify_batch(batch, bucket=256)
        kw["sparse_hw"] = batch.pop("hw")
    if mode == "accum2":
        kw["accum_steps"] = 2
    sd = state_dict_from_jax(variables)
    sd0 = {k: v.clone() for k, v in sd.items()}
    model = get_model("uresnet", sd, policy=policy, device="cpu", train=True)
    opt = port_opt.make_optimizer(model.parameters(), "sgd", LR,
                                  weight_decay=1e-3, momentum=0.9)
    state, metrics = build_train_step(**kw)(create_train_state(model, opt),
                                            batch)
    assert state.step == 1 and metrics["nan_skipped"] == 0
    assert all(torch.equal(sd[k], v) for k, v in sd0.items())  # a copy
    np.testing.assert_allclose(metrics["loss"], want_m["loss"], rtol=1e-5)
    assert set(metrics) == set(want_m)
    for k, v in want_m.items():
        if k != "loss":
            assert abs(metrics[k] - v) <= 1e-6, (k, metrics[k], v)
    _assert_stats(model.state_dict(), want_sd, 5e-5)
    gsc = max(float(p.grad.abs().max()) for p in model.parameters())
    for k, p in model.named_parameters():
        np.testing.assert_allclose(
            p.detach().numpy(), want_sd[k].numpy(), rtol=1e-5,
            atol=LR * GRAD_FLOOR * gsc, err_msg=k)


@pytest.mark.parametrize("name,schedule", [("adam", "constant"),
                                           ("adam", "step"),
                                           ("sgd", "step")])
def test_optimizers_match_jax(rng, name, schedule):
    """Three updates from the same numpy gradients: Adam (torch-style L2
    decay before the moments) and SGD with momentum, under a constant
    and the step schedule (lr · 0.5^(step // 2))."""
    shapes = [(4, 3, 3, 3), (7,)]
    w0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(np.float32) for s in shapes]
          for _ in range(3)]
    kw = dict(decay_factor=0.5, decay_every=2)
    wd = 1e-4 if name == "adam" else 1e-3
    tx = jax_opt.make_optimizer(
        name, learning_rate=jax_sched.make_schedule(schedule, 1e-2, **kw),
        weight_decay=wd, momentum=0.9)
    jw = [jnp.asarray(w) for w in w0]
    ost = tx.init(jw)
    for g in gs:
        upd, ost = tx.update([jnp.asarray(x) for x in g], ost, jw)
        jw = [a + u for a, u in zip(jw, upd)]

    params = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    opt = port_opt.make_optimizer(
        params, name, port_sched.make_schedule(schedule, 1e-2, **kw),
        weight_decay=wd, momentum=0.9)
    for g in gs:
        opt.zero_grad()
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    assert opt.count == 3
    for p, w in zip(params, jw):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


def test_non_finite_step_changes_nothing(variables):
    """A NaN in the batch: the step skips the whole update — parameters,
    Adam's state and count, BN running stats — and counts it."""
    model = get_model("uresnet", state_dict_from_jax(variables),
                      policy=F32, device="cpu", train=True)
    opt = port_opt.make_optimizer(model.parameters(), "adam", 1e-3,
                                  weight_decay=1e-4)
    step = build_train_step(device="cpu")
    state, m = step(create_train_state(model, opt), _batch(3))
    assert m["nan_skipped"] == 0 and opt.count == 1
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = {i: {k: v.clone() for k, v in s.items()}
                  for i, s in opt.state_dict()["torch"]["state"].items()}
    bad = _batch(4)
    bad["image"][0, 5, 5, 0] = np.nan
    state, m = step(state, bad)
    assert m["nan_skipped"] == 1 and state.nan_count == 1 and state.step == 2
    assert not np.isfinite(m["loss"])
    assert opt.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for i, s in opt.state_dict()["torch"]["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_before[i][k]), (i, k)


def test_sparse_batch_forms_match_jax():
    """sparsify_batch: the same arrays as JAX's (both numpy);
    densify_batch: image and labels back exactly, weights as JAX's
    densify gives them (base + residual, within one f32 rounding of
    the original)."""
    batch = _batch(5, b=3, hw=32)
    batch["image"][2] = 1.0  # no empty pixel: the median base
    sp = port_sparse.sparsify_batch(batch, bucket=64)
    sj = jax_sparse.sparsify_batch(batch, bucket=64)
    assert sp.pop("hw") == sj.pop("hw") == (32, 32)
    assert set(sp) == set(sj)
    for k in sj:
        np.testing.assert_array_equal(sp[k], sj[k], err_msg=k)
    dense = port_sparse.densify_batch(
        {k: torch.from_numpy(v) for k, v in sp.items()}, (32, 32))
    dj = jax_sparse.densify_batch({k: jnp.asarray(v) for k, v in sj.items()},
                                  (32, 32))
    np.testing.assert_array_equal(dense["image"].numpy(), batch["image"])
    np.testing.assert_array_equal(dense["label"].numpy(), batch["label"])
    assert dense["label"].dtype == torch.int32
    np.testing.assert_array_equal(dense["weight"].numpy(),
                                  np.asarray(dj["weight"]))
    np.testing.assert_allclose(dense["weight"].numpy(), batch["weight"],
                               rtol=1e-6)


def test_train_step_runs_the_zone_table(variables, monkeypatch):
    """One bf16 train step at the flagship width routes exactly the
    per-step table through the kernel wrappers (here their plain
    versions): K5 x16, K1 x18 (the classifier forward and 17 input
    gradients), K6 x17, K4 x1, K7 forward and backward x1 each."""
    calls = {}

    def count(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    count(train_ops, "conv_stats")
    count(conv_ops, "conv_bn_act")
    count(conv_ops, "conv_dw")
    count(pool_ops, "maxpool3x3s2")
    count(loss_ops, "weighted_nll_fwd")
    count(loss_ops, "weighted_nll_bwd")
    model = get_model("uresnet", state_dict_from_jax(variables),
                      device="cpu", train=True)
    opt = port_opt.make_optimizer(model.parameters(), "adam", 1e-3)
    _, m = build_train_step(use_pallas_loss=True, device="cpu")(
        create_train_state(model, opt), _batch(6))
    assert np.isfinite(m["loss"])
    assert calls == {"conv_stats": 16, "conv_bn_act": 18, "conv_dw": 17,
                     "maxpool3x3s2": 1, "weighted_nll_fwd": 1,
                     "weighted_nll_bwd": 1}


def test_pallas_loss_refuses_class_weights():
    with pytest.raises(NotImplementedError, match="class_weights"):
        build_train_step(class_weights=[1.0, 2.0, 3.0], use_pallas_loss=True,
                         device="cpu")
