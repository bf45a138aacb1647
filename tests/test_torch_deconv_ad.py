"""The deconv's backward in the port (ubresnet_tpu_torch/ops/deconv.py:
K8 conv_s2k4, K9 deconv_dw and deconv2x_ad, as their wrappers run them
on CPU tensors) against the JAX Pallas kernels they replace, which run
in interpret mode on W-packed tensors as tests/test_pallas_conv.py runs
them, at the flagship (ci, co) pairs: (64, 32) with p = 4 (dec2) and
(32, 16) with p = 8 (dec1), and at the 8-channel streams' (16, 8) with
p = 8 and (8, 4) with p = 16. Same numpy inputs to both, float32, the
JAX tests' tolerances:

  * conv_s2k4 vs fused_conv_s2k4 (the dx leg, fed the in/out-transposed
    kernel as _deconv_ad_bwd feeds it): atol 2e-5;
  * deconv_dw vs pallas_deconv_dw: rtol 1e-4, atol 1e-3;
  * deconv2x_ad vs pallas_deconv2x_ad: loss rtol 2e-5, dx rtol 1e-4 /
    atol 1e-4, dW rtol 1e-4 / atol 1e-3 (test_deconv2x_ad_grads_match_
    packed).

deconv2x_ad is also held against F.conv_transpose2d's own autograd in
float64, at odd and even H and W (the JAX kernels take packed widths
only): within 2e-5·max of each output, the float32 rounding of sums of
up to 16·ci terms.

Model level: TrainUResNet with fused_train and fused_train_deconv in
float32 against JAX Policy.f32 on the same weights and batch, at
tests/test_torch_train.py's tolerances (logits 1e-4·max, loss rtol
1e-5, running stats 5e-5·max, every gradient 5e-2·max|grad|); and the
per-step launch table of a bf16 step with and without the flag."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import import_uresnet_state_dict
from ubresnet_tpu.losses import pixelwise_weighted_nll_from_logits as jax_nll
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu.ops.packed import pack, unpack
from ubresnet_tpu.ops.pallas_conv import (
    deconv_ad_supported,
    fused_conv_s2k4,
    pallas_deconv2x_ad,
    pallas_deconv_dw,
)
from ubresnet_tpu.parity.torch_oracle import make_state_dict
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import state_dict_from_jax
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import deconv as deconv_ops
from ubresnet_tpu_torch.ops import loss as loss_ops
from ubresnet_tpu_torch.ops import pool as pool_ops
from ubresnet_tpu_torch.ops import train_conv as train_ops
from ubresnet_tpu_torch.ops.deconv import conv_s2k4, deconv2x_ad, deconv_dw
from ubresnet_tpu_torch.ops.loss import weighted_nll
from ubresnet_tpu_torch.train import optimizers as port_opt
from ubresnet_tpu_torch.train.step import build_train_step, create_train_state

torch.set_num_threads(1)

# (ci, co, p, H, W): the deconv's input side, unpacked; the flagship's
# and, under the 8-channel streams, dec1 at inplanes 8 (dec2 at 4) and
# dec1 at 4, at their lane packs
FLAGSHIP = [(64, 32, 4, 8, 64), (32, 16, 8, 16, 128)]
IDS = ["dec2", "dec1"]
EIGHT = [(16, 8, 8, 16, 128), (8, 4, 16, 16, 256)]
EIGHT_IDS = ["c16-8", "c8-4"]


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _data(rng, ci, co, h, w):
    x = rng.randn(2, h, w, ci).astype(np.float32)
    wk = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    dy = rng.randn(2, 2 * h, 2 * w, co).astype(np.float32)
    return x, wk, dy


@pytest.mark.parametrize("ci,co,p,h,w", FLAGSHIP + EIGHT,
                         ids=IDS + EIGHT_IDS)
def test_conv_s2k4_matches_pallas(rng, ci, co, p, h, w):
    _, wk, dy = _data(rng, ci, co, h, w)
    want = fused_conv_s2k4(pack(jnp.asarray(dy), 2 * p),
                           jnp.asarray(wk.transpose(0, 1, 3, 2)), p=p, th=4,
                           interpret=True)
    got = conv_s2k4(_t(dy), _t(wk))
    assert got.shape == (2, h, w, ci) and got.dtype == torch.float32
    _close(got, unpack(want, p), 0.0, 2e-5)


@pytest.mark.parametrize("ci,co,p,h,w", FLAGSHIP + EIGHT,
                         ids=IDS + EIGHT_IDS)
def test_deconv_dw_matches_pallas(rng, ci, co, p, h, w):
    x, _, dy = _data(rng, ci, co, h, w)
    want = pallas_deconv_dw(pack(jnp.asarray(x), p),
                            pack(jnp.asarray(dy), 2 * p), p=p, th=4,
                            interpret=True)
    got = deconv_dw(_t(x), _t(dy))
    assert got.shape == (4, 4, ci, co) and got.dtype == torch.float32
    _close(got, want, 1e-4, 1e-3)


@pytest.mark.parametrize("ci,co,p,h,w", FLAGSHIP + EIGHT,
                         ids=IDS + EIGHT_IDS)
def test_deconv2x_ad_matches_pallas(rng, ci, co, p, h, w):
    assert deconv_ad_supported(p, ci, co)
    assert all((ci, co) in t for t in (deconv_ops.SHAPES,
                                        deconv_ops.S2K4_SHAPES,
                                        deconv_ops.DW_SHAPES))
    x, wk, r = _data(rng, ci, co, h, w)
    r_p = pack(jnp.asarray(r), p)
    want, (dx_j, dw_j) = jax.value_and_grad(
        lambda x, w: jnp.sum(pallas_deconv2x_ad(x, w, p, True) * r_p),
        (0, 1))(pack(jnp.asarray(x), p), jnp.asarray(wk))
    tx, tw = _t(x, True), _t(wk, True)
    loss = (deconv2x_ad(tx, tw) * _t(r)).sum()
    loss.backward()
    _close(loss.item(), float(want), 2e-5)
    _close(tx.grad, unpack(dx_j, p), 1e-4, 1e-4)
    _close(tw.grad, dw_j, 1e-4, 1e-3)


@pytest.mark.parametrize("hw", [(8, 12), (5, 7)], ids=["even", "odd"])
@pytest.mark.parametrize("ci,co", [(64, 32), (32, 16)], ids=IDS)
def test_deconv2x_ad_matches_torch_autograd(rng, ci, co, hw):
    """y, dx and dW of deconv2x_ad (float32, the kernels' plain
    versions) against F.conv_transpose2d's autograd in float64 with the
    reference IOHW kernel: the layout (no spatial flip, co contracted
    for dx) and both image edges, where the taps reach outside."""
    x, wk, _ = _data(rng, ci, co, *hw)
    r = rng.randn(2, 2 * hw[0], 2 * hw[1], co)
    xr = torch.from_numpy(x).double().requires_grad_(True)
    wr = torch.from_numpy(wk).double().requires_grad_(True)
    yr = F.conv_transpose2d(xr.permute(0, 3, 1, 2), wr.permute(2, 3, 0, 1),
                            stride=2, padding=1).permute(0, 2, 3, 1)
    (yr * torch.from_numpy(r)).sum().backward()
    tx, tw = _t(x, True), _t(wk, True)
    y = deconv2x_ad(tx, tw)
    (y * torch.from_numpy(r).float()).sum().backward()
    for got, want in ((y.detach(), yr.detach()), (tx.grad, xr.grad),
                      (tw.grad, wr.grad)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = float((got.double() - want).abs().max())
        assert err <= 2e-5 * float(want.abs().max()), err


def _batch(seed, b=2, hw=64):
    """Sparse ADC-like crop, labels on the hits, class-balancing-like
    weights (as tests/test_torch_train.py)."""
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


@pytest.fixture(scope="module")
def variables():
    sd = make_state_dict(np.random.RandomState(0), inplanes=16)
    return import_uresnet_state_dict({k: v.numpy() for k, v in sd.items()})


def _assert_stats(got_sd, want_sd, tol):
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        want = want_sd[k].double()
        err = float((got_sd[k].double() - want).abs().max())
        assert err <= tol * float(want.abs().max()), (k, err)


def test_deconv_ad_train_step_matches_jax(variables):
    """fused_train + fused_train_deconv in float32 (the zone's and the
    deconv legs' plain versions, the loss kernel's): logits, loss, BN
    running-stat updates and every parameter gradient ≡ JAX Policy.f32
    (its XLA deconv under autograd)."""
    batch = _batch(1)
    model_j = jax_get_model("uresnet", policy=JaxPolicy.f32(),
                            input_channels=1, inplanes=16)

    @jax.jit
    def run(params):
        def loss(p):
            out, upd = model_j.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                jnp.asarray(batch["image"]), train=True, logits=True,
                mutable=["batch_stats"])
            return jax_nll(out, batch["label"], batch["weight"]), (out, upd)

        return jax.value_and_grad(loss, has_aux=True)(params)

    (want_loss, (want_logits, upd)), grads = run(variables["params"])
    want = state_dict_from_jax({"params": grads,
                                "batch_stats": upd["batch_stats"]})
    policy = dataclasses.replace(Policy.f32(), fused_train=True,
                                 fused_train_deconv=True)
    model = get_model("uresnet", state_dict_from_jax(variables),
                      policy=policy, device="cpu", train=True)
    assert sum(getattr(m, "ad", False) for m in model.modules()) == 2
    logits = model(torch.from_numpy(batch["image"]), logits=True)
    loss = weighted_nll(logits, torch.from_numpy(batch["label"]),
                        torch.from_numpy(batch["weight"]))
    loss.backward()
    scale = float(np.abs(np.asarray(want_logits)).max())
    assert float(np.abs(logits.detach().numpy()
                        - np.asarray(want_logits)).max()) <= 1e-4 * scale
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _assert_stats(model.state_dict(), want, 5e-5)
    params = dict(model.named_parameters())
    gsc = max(float(want[k].abs().max()) for k in params)
    for k, p in params.items():
        err = float((p.grad - want[k]).abs().max())
        assert err < 5e-2 * gsc, (k, err, gsc)


@pytest.mark.parametrize("deconv_ad", [False, True], ids=["off", "on"])
def test_train_step_launch_table_with_deconv_ad(variables, monkeypatch,
                                                deconv_ad):
    """One bf16 step at the flagship width through the kernel wrappers
    (their plain versions here): the zone's table (K5 16, K1 18, K6 17,
    K4 1, K7 1 + 1) and, with fused_train_deconv, K3 2 and K10 2 more
    (the backward's two legs in one launch: no K8 or K9); without it
    none of them."""
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
    for name in ("deconv2x", "conv_s2k4", "deconv_dw", "deconv2x_bwd"):
        count(deconv_ops, name)
    policy = dataclasses.replace(Policy(), fused_train_deconv=deconv_ad)
    model = get_model("uresnet", state_dict_from_jax(variables),
                      policy=policy, device="cpu", train=True)
    opt = port_opt.make_optimizer(model.parameters(), "adam", 1e-3)
    _, m = build_train_step(use_pallas_loss=True, device="cpu")(
        create_train_state(model, opt), _batch(6))
    assert np.isfinite(m["loss"])
    want = {"conv_stats": 16, "conv_bn_act": 18, "conv_dw": 17,
            "maxpool3x3s2": 1, "weighted_nll_fwd": 1, "weighted_nll_bwd": 1}
    if deconv_ad:
        want.update(deconv2x=2, deconv2x_bwd=2)
    assert calls == want
