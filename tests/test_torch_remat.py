"""Remat in the port (Policy.remat: each encoder and decoder stage
recomputed in backward; the train step's ``remat``: the whole forward)
on the CPU, flagship width (inplanes 16) at 64x64, batch 2.

Recomputing changes no arithmetic, so against the same run without
remat the loss, every gradient, the parameters after SGD and the BN
running stats must be equal bit for bit, after one step and after two.
The recompute runs the forward a second time and the port's train-mode
BatchNorm updates its running stats in place, so a remat whose
recompute also moved them (the mutant below) must fail that check.
Against JAX's remat step (Policy.remat and build_train_step(remat=True),
float32): the tolerances of tests/test_torch_train.py's one SGD step —
loss at rtol 1e-5, running stats within 5e-5·max|stat|, parameters
within lr·5e-2·max|grad|."""
import contextlib
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import import_uresnet_state_dict
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu.parity.torch_oracle import make_state_dict
from ubresnet_tpu.train import optimizers as jax_opt
from ubresnet_tpu.train import step as jax_step
from ubresnet_tpu_torch.cli.train import main as train_main
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.deploy.weights import state_dict_from_jax
from ubresnet_tpu_torch.models import blocks, get_model
from ubresnet_tpu_torch.train import optimizers as port_opt
from ubresnet_tpu_torch.train.step import build_train_step, create_train_state

torch.set_num_threads(1)

F32_ZONE = dataclasses.replace(Policy.f32(), fused_train=True)
LR = 1e-2
GRAD_FLOOR = 5e-2
MODES = {"none": (False, False), "stage": (True, False),
         "whole": (False, True)}


@pytest.fixture(scope="module")
def variables():
    sd = make_state_dict(np.random.RandomState(0), inplanes=16)
    return import_uresnet_state_dict({k: v.numpy() for k, v in sd.items()})


def _batch(seed, b=2, hw=64):
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


def _run_port(variables, mode, policy=F32_ZONE, steps=2):
    """[(metrics, {param grad}, state_dict)] after each SGD step."""
    stage, whole = MODES[mode]
    pol = dataclasses.replace(policy, remat=stage)
    model = get_model("uresnet", state_dict_from_jax(variables), policy=pol,
                      device="cpu", train=True)
    opt = port_opt.make_optimizer(model.parameters(), "sgd", LR,
                                  weight_decay=1e-3, momentum=0.9)
    step = build_train_step(num_classes=3,
                            use_pallas_loss=policy.fused_train,
                            remat=whole, device="cpu")
    state = create_train_state(model, opt)
    out = []
    for i in range(steps):
        state, metrics = step(state, _batch(2 + i))
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        out.append((metrics, grads, {k: v.clone() for k, v in
                                     model.state_dict().items()}))
    return out


@pytest.fixture(scope="module")
def no_remat(variables):
    return _run_port(variables, "none")


def _differences(got, want):
    """Names of everything that is not bit-equal, over the steps."""
    bad = []
    for i, ((gm, gg, gs), (wm, wg, ws)) in enumerate(zip(got, want)):
        bad += [f"{i}:metric:{k}" for k in wm if gm[k] != wm[k]]
        bad += [f"{i}:grad:{k}" for k in wg if not torch.equal(gg[k], wg[k])]
        bad += [f"{i}:state:{k}" for k in ws if not torch.equal(gs[k], ws[k])]
    return bad


@pytest.mark.parametrize("mode", ["stage", "whole"])
def test_remat_is_bit_equal_to_no_remat(variables, no_remat, mode):
    """Loss, gradients, parameters and BN running stats after one and
    after two SGD steps, the zone's plain versions included."""
    got = _run_port(variables, mode)
    assert len(got) == 2
    assert _differences(got, no_remat) == []


@pytest.mark.parametrize("mode", ["stage", "whole"])
def test_double_bn_update_mutant_fails(variables, no_remat, monkeypatch,
                                       mode):
    """With the recompute's BN freeze taken out, the running stats move
    twice a step and the bit-equality check catches it (and only the
    running stats differ)."""
    monkeypatch.setattr(blocks, "frozen_stats",
                        lambda module: contextlib.nullcontext())
    bad = _differences(_run_port(variables, mode, steps=1), no_remat)
    assert bad and all(":state:" in b and b.endswith(
        ("running_mean", "running_var")) for b in bad), bad


def test_remat_step_matches_jax_remat(variables):
    """One SGD step with both remats on: the port against JAX's step
    with Policy.remat (nn.remat per stage) and remat=True
    (jax.checkpoint of the forward), float32."""
    model = jax_get_model(
        "uresnet", policy=dataclasses.replace(JaxPolicy.f32(), remat=True),
        input_channels=1, inplanes=16)
    tx = jax_opt.make_optimizer("sgd", learning_rate=LR, weight_decay=1e-3,
                                momentum=0.9)
    state = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        best_metric=jnp.zeros((), jnp.float32),
        nan_count=jnp.zeros((), jnp.int32), apply_fn=model.apply, tx=tx)
    batch = _batch(2)
    new, jm = jax_step.build_train_step(num_classes=3, donate=False,
                                        remat=True)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    want = state_dict_from_jax({"params": new.params,
                                "batch_stats": new.batch_stats})

    pol = dataclasses.replace(Policy.f32(), remat=True)
    port = get_model("uresnet", state_dict_from_jax(variables), policy=pol,
                     device="cpu", train=True)
    opt = port_opt.make_optimizer(port.parameters(), "sgd", LR,
                                  weight_decay=1e-3, momentum=0.9)
    _, metrics = build_train_step(num_classes=3, remat=True, device="cpu")(
        create_train_state(port, opt), batch)
    np.testing.assert_allclose(metrics["loss"], float(jm["loss"]), rtol=1e-5)
    got = port.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            scale = float(want[k].abs().max())
            assert float((got[k] - want[k]).abs().max()) <= 5e-5 * scale, k
    gsc = max(float(p.grad.abs().max()) for p in port.parameters())
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=LR * GRAD_FLOOR * gsc,
                                   err_msg=k)


def test_train_cli_runs_with_model_remat(tmp_path, capsys):
    data = make_synthetic_file(str(tmp_path / "t.uevt"), n_events=4,
                               hw=(64, 64), seed=3)
    cfg = {"model": {"precision": "bf16"}, "optim": {"lr": 1e-3},
           "train_data": {"files": [data], "batch_size": 2, "n_threads": 1,
                          "sparse_bucket": 512},
           "num_iters": 2, "print_every": 1,
           "checkpoint_dir": str(tmp_path / "ckpt"), "seed": 1}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert train_main(["--config", str(path), "--device", "cpu",
                       "--set", "model.remat=true"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.rfind("\n{\n") + 1:])
    assert summary["final_iter"] == 2 and summary["nan_steps_skipped"] == 0
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("iter ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
