"""int8 QAT in the port (Policy.quant_train; ops/quant.py:fake_quant_*)
against the JAX package on the same numpy inputs and weights.

The fake-quantizers are held bit-exact, outputs and gradients, to JAX's
as its models run them, under jit (where XLA compiles every ``/ 127``
as a multiply by the rounded reciprocal): abs-max, ties at the clip
bound (gradient exactly 1), values outside it (gradient 0), an all-zero
batch (passes unchanged), percentile 99.0 on a W-packed view above the
2^20-element subsample cap.

Layers in train mode, float32, under Policy(pack_width=8,
compute_dtype=f32, quant_train=True) — JAX's packed zone, where its QAT
acts: a ConvBN (stem and enc1 shapes) and a deconv (dec2, dec1) agree
within 1e-5·max of the output and 1e-4·max of each gradient: the
fake-quantized inputs and kernels are bit-exact, so what is left is
float32 sums in another order. A BasicBlock (dual stream, projection)
fake-quantizes cb2's input, conv1's post-BN output, where those sums
can move a value across a .5 boundary of the int8 grid (one step of one
element): 99.9% of its outputs within 1e-5·max, all within 5e-2·max.

The whole UResNet in float32: every fake-quant after a train-mode BN
can flip such roundings, and the flips cascade through the zone, so
JAX itself moves its logits by ~9% of their max under 1e-6 relative
noise on its weights. The port is held to twice JAX's own spread under
that noise (logits, loss, gradients; argmax within 2% of it). The eval
forward is also compared in float64 (JAX with x64), where eval has no
batch statistics and nothing flips: within 1e-5·max, argmax exact."""
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
from ubresnet_tpu.models.blocks import BasicBlock as JaxBlock
from ubresnet_tpu.models.blocks import ConvBN as JaxConvBN
from ubresnet_tpu.models.blocks import Deconv2x as JaxDeconv
from ubresnet_tpu.ops import quant as jq
from ubresnet_tpu.ops.packed import pack, unpack
from ubresnet_tpu.parity.torch_oracle import make_state_dict
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import state_dict_from_jax
from ubresnet_tpu_torch.losses import pixelwise_weighted_nll_from_logits
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.models.blocks import (
    BatchNorm,
    Conv,
    TrainBasicBlock,
    TrainDeconv2x,
    conv_bn,
)
from ubresnet_tpu_torch.ops import quant

torch.set_num_threads(1)

JAX_QAT = JaxPolicy(pack_width=8, compute_dtype=jnp.float32,
                    quant_train=True)
QAT = dataclasses.replace(Policy.f32(), quant_train=True)
_jfq_act = jax.jit(jq.fake_quant_act, static_argnums=1)
_jfq_w = jax.jit(jq.fake_quant_weight)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("shape", [(7, 7, 1, 16), (4, 4, 64, 32)],
                         ids=["stem", "deconv"])
def test_fake_quant_weight_bit_exact(rng, shape):
    w = (rng.randn(*shape) * rng.rand(shape[-1]) * 0.2).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output channel: the 1e-12 floor
    cot = rng.randn(*shape).astype(np.float32)
    want = _jfq_w(jnp.asarray(w))
    want_g = jax.jit(jax.grad(lambda v: jnp.sum(jq.fake_quant_weight(v)
                                                * cot)))(jnp.asarray(w))
    tw = _t(w, True)
    got = quant.fake_quant_weight(tw)
    (got * _t(cot)).sum().backward()
    _exact(got.detach(), want)
    _exact(tw.grad, want_g)  # identity STE


def _act_case(rng, case):
    """(x, percentile, pack) of each fake_quant_act case."""
    x = (np.maximum(rng.randn(2, 8, 32, 16), 0) * 7).astype(np.float32)
    if case == "tie_at_bound":  # the abs-max element sits on ±lim
        x[0, 0, 0, :2] = [-x.max() * 1.5, x.max() * 1.5]
        return x, 0.0, 1
    if case == "outliers_p99":  # 1% clip: values outside get gradient 0
        x.flat[rng.choice(x.size, 40, replace=False)] = 1e3
        return x, 99.0, 1
    if case == "all_zero":
        return np.zeros_like(x), 99.9, 1
    if case == "packed_p99":  # above 2^20 elements: the packed grid
        return (np.maximum(rng.randn(2, 128, 512, 16), 0)
                * 3).astype(np.float32), 99.0, 8
    return x, 0.0, 1


@pytest.mark.parametrize("case", ["absmax", "tie_at_bound", "outliers_p99",
                                  "all_zero", "packed_p99"])
def test_fake_quant_act_bit_exact(rng, case):
    x, pct, p = _act_case(rng, case)
    cot = rng.randn(*x.shape).astype(np.float32)

    def jax_fq(v):
        return unpack(jq.fake_quant_act(pack(v, p), pct), p)

    want = jax.jit(jax_fq)(jnp.asarray(x))
    want_g = jax.jit(jax.grad(lambda v: jnp.sum(jax_fq(v) * cot)))(
        jnp.asarray(x))
    tx = _t(x, True)
    got = quant.fake_quant_act(tx, pct, p)
    (got * _t(cot)).sum().backward()
    _exact(got.detach(), want)
    _exact(tx.grad, want_g)
    g = tx.grad.numpy() / cot
    if case == "tie_at_bound":
        assert g[0, 0, 0, 0] == 1.0 and g[0, 0, 0, 1] == 1.0
    if case == "outliers_p99":  # the outliers and the bulk's top 1% clip
        assert set(np.unique(g)) == {0.0, 1.0} and (g[x == 1e3] == 0).all()
        assert (g[x < 1e3] == 1).mean() > 0.99
    if case == "all_zero":
        _exact(got.detach(), x)
        assert (g == 1).all()


def _bn_params(rng, c):
    return {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
            "bias": (0.1 * rng.randn(c)).astype(np.float32),
            "mean": (0.1 * rng.randn(c)).astype(np.float32),
            "var": (1 + 0.2 * rng.rand(c)).astype(np.float32)}


def _bn_sd(key, bn):
    return {f"{key}.weight": _t(bn["scale"]), f"{key}.bias": _t(bn["bias"]),
            f"{key}.running_mean": _t(bn["mean"]),
            f"{key}.running_var": _t(bn["var"])}


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("ci,co,k,bias,p", [(1, 16, 7, True, 8),
                                            (16, 32, 3, False, 4)],
                         ids=["stem", "enc1"])
def test_qat_conv_bn_matches_jax(rng, ci, co, k, bias, p):
    """Train-mode ConvBN under QAT: the input and kernel fake-quantized,
    batch-statistics BN, ReLU; output, running stats and the gradients
    of the input, kernel, bias and BN affine."""
    x = (np.maximum(rng.randn(2, 16, 64, ci), 0) * 5).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.2).astype(np.float32)
    b = (0.1 * rng.randn(co)).astype(np.float32)
    bn = _bn_params(rng, co)
    r = rng.randn(2, 16, 64, co).astype(np.float32)
    params = {"conv": {"kernel": jnp.asarray(w)},
              "bn": {"scale": jnp.asarray(bn["scale"]),
                     "bias": jnp.asarray(bn["bias"])}}
    if bias:
        params["conv"]["bias"] = jnp.asarray(b)
    stats = {"bn": {"mean": jnp.asarray(bn["mean"]),
                    "var": jnp.asarray(bn["var"])}}
    mod = JaxConvBN(co, k, 1, use_bias=bias, packed=p, policy=JAX_QAT)

    def loss_j(params, xp):
        y, upd = mod.apply({"params": params, "batch_stats": stats}, xp,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(y * pack(jnp.asarray(r), p)), (y, upd)

    (lj, (yj, upd)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss_j, (0, 1), has_aux=True))(params, pack(jnp.asarray(x), p))
    sd = {"c.weight": _t(w.transpose(3, 2, 0, 1)), **_bn_sd("b", bn)}
    if bias:
        sd["c.bias"] = _t(b)
    conv = Conv(sd, "c", policy=QAT, device="cpu", qat=True, qpack=p)
    bnm = BatchNorm(sd, "b", policy=QAT, device="cpu").train()
    tx = _t(x, True)
    y = conv_bn(conv, bnm, tx, act=True)
    (y * _t(r)).sum().backward()
    assert _rel(y.detach(), unpack(yj, p)) <= 1e-5
    assert _rel(bnm.running_mean, upd["batch_stats"]["bn"]["mean"]) <= 1e-5
    assert _rel(bnm.running_var, upd["batch_stats"]["bn"]["var"]) <= 1e-5
    assert _rel(tx.grad, unpack(gx, p)) <= 1e-4
    assert _rel(conv.weight.grad.permute(2, 3, 1, 0), gp["conv"]["kernel"]) \
        <= 1e-4
    if bias:  # zero but for rounding: the batch-statistics BN removes it
        err = float(np.abs(conv.bias.grad.numpy()
                           - np.asarray(gp["conv"]["bias"])).max())
        assert err <= 1e-4 * float(np.abs(np.asarray(gp["conv"]["kernel"]))
                                   .max())
    assert _rel(bnm.weight.grad, gp["bn"]["scale"]) <= 1e-4
    assert _rel(bnm.bias.grad, gp["bn"]["bias"]) <= 1e-4


@pytest.mark.parametrize("ci,co,p,h", [(64, 32, 4, 8), (32, 16, 8, 16)],
                         ids=["dec2", "dec1"])
@pytest.mark.parametrize("deconv_ad", [False, True], ids=["xla", "ad"])
def test_qat_deconv_matches_jax(rng, ci, co, p, h, deconv_ad):
    """Train-mode deconv under QAT, the input and kernel fake-quantized
    before it routes (F.conv_transpose2d, or deconv2x_ad with
    fused_train_deconv — JAX's packed_deconv2x either way, which its
    Pallas AD path matches): output and the input and kernel
    gradients."""
    w_in = 8 * p
    x = (np.maximum(rng.randn(2, h, w_in, ci), 0) * 3).astype(np.float32)
    wk = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    r = rng.randn(2, 2 * h, 2 * w_in, co).astype(np.float32)
    mod = JaxDeconv(co, p, JAX_QAT)

    def loss_j(kernel, xp):
        y = mod.apply({"params": {"kernel": kernel}}, xp,
                      target_hw=(2 * h, 2 * w_in), train=True)
        return jnp.sum(y * pack(jnp.asarray(r), p)), y

    (_, yj), (gw, gx) = jax.jit(jax.value_and_grad(
        loss_j, (0, 1), has_aux=True))(jnp.asarray(wk),
                                       pack(jnp.asarray(x), p))
    pol = dataclasses.replace(QAT, fused_train_deconv=deconv_ad)
    m = TrainDeconv2x({"d.weight": _t(wk.transpose(2, 3, 0, 1))}, "d",
                      policy=pol, device="cpu", qat=True, qpack=p)
    assert m.ad == deconv_ad
    tx = _t(x, True)
    y = m(tx, (2 * h, 2 * w_in))
    (y * _t(r)).sum().backward()
    assert _rel(y.detach(), unpack(yj, p)) <= 1e-5
    assert _rel(tx.grad, unpack(gx, p)) <= 1e-4
    assert _rel(m.weight.grad.permute(2, 3, 0, 1), gw) <= 1e-4


def test_qat_block_matches_jax(rng):
    """Train-mode dec1.res1-shaped BasicBlock under QAT ([up, skip]
    joined, 1x1 projection): cb1, the bypass and cb2 fake-quantize
    their inputs; cb2's is conv1's post-BN output, where one element may
    round a step apart (the module docstring)."""
    p, c = 8, 16
    a = (np.maximum(rng.randn(2, 16, 64, c), 0) * 2).astype(np.float32)
    d = (np.maximum(rng.randn(2, 16, 64, c), 0) * 2).astype(np.float32)
    r = rng.randn(2, 16, 64, c).astype(np.float32)
    w1 = (rng.randn(3, 3, 2 * c, c) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, c, c) * 0.1).astype(np.float32)
    wb = (rng.randn(1, 1, 2 * c, c) * 0.2).astype(np.float32)
    bns = {n: _bn_params(rng, c) for n in ("cb1", "cb2", "bypass")}
    params = {n: {"conv": {"kernel": jnp.asarray(w)},
                  "bn": {"scale": jnp.asarray(bns[n]["scale"]),
                         "bias": jnp.asarray(bns[n]["bias"])}}
              for n, w in (("cb1", w1), ("cb2", w2), ("bypass", wb))}
    stats = {n: {"bn": {"mean": jnp.asarray(bns[n]["mean"]),
                        "var": jnp.asarray(bns[n]["var"])}} for n in bns}
    mod = JaxBlock(c, 1, packed=p, policy=JAX_QAT)
    y_j, _ = jax.jit(lambda pr, a, d: mod.apply(
        {"params": pr, "batch_stats": stats}, a, train=True, dual=d,
        mutable=["batch_stats"]))(params, pack(jnp.asarray(a), p),
                                  pack(jnp.asarray(d), p))
    sd = {}
    for n, ck, bk, w in (("cb1", "conv1", "bn1", w1), ("cb2", "conv2", "bn2",
                                                      w2),
                         ("bypass", "bypass", "bnpass", wb)):
        sd[f"blk.{ck}.weight"] = _t(w.transpose(3, 2, 0, 1))
        sd.update(_bn_sd(f"blk.{bk}", bns[n]))
    blk = TrainBasicBlock(sd, "blk", policy=QAT, device="cpu", qat=True,
                          qpack=p).train()
    y = blk(_t(a), _t(d)).detach().numpy()
    want = np.asarray(unpack(y_j, p))
    err = np.abs(y - want)
    scale = np.abs(want).max()
    assert (err <= 1e-5 * scale).mean() >= 0.999
    assert err.max() <= 5e-2 * scale
    blk(_t(a), _t(d)).backward(_t(r))  # the STE gradients flow
    assert all(torch.isfinite(q.grad).all() for q in blk.parameters())


@pytest.fixture(scope="module")
def model_case():
    sd = make_state_dict(np.random.RandomState(0), inplanes=16)
    variables = import_uresnet_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    rng = np.random.RandomState(1)
    b, hw = 2, 64
    img = np.zeros((b, hw, hw, 1), np.float32)
    lab = np.zeros((b, hw, hw), np.int32)
    wgt = np.full((b, hw, hw), 0.4, np.float32)
    for i in range(b):
        n = 300
        ys, xs = rng.randint(0, hw, n), rng.randint(0, hw, n)
        img[i, ys, xs, 0] = rng.rand(n) * 50 + 5
        lab[i, ys, xs] = rng.randint(1, 3, n)
        wgt[i, ys, xs] = rng.rand(n) * 5 + 1
    noise = np.random.RandomState(3)
    perturbed = jax.tree_util.tree_map(
        lambda t: t * (1 + 1e-6 * noise.randn(*t.shape).astype(np.float32)),
        variables)
    return variables, perturbed, img, lab, wgt


def _jax_train(variables, img, lab, wgt):
    model = jax_get_model("uresnet", policy=JAX_QAT, input_channels=1,
                          inplanes=16)

    @jax.jit
    def run(params):
        def loss(p):
            out, _ = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                jnp.asarray(img), train=True, logits=True,
                mutable=["batch_stats"])
            return jax_nll(out, lab, wgt), out

        return jax.value_and_grad(loss, has_aux=True)(params)

    (loss, logits), grads = run(variables["params"])
    return float(loss), np.asarray(logits), state_dict_from_jax(
        {"params": grads, "batch_stats": variables["batch_stats"]})


def _spread(loss_a, logits_a, grads_a, loss_b, logits_b, grads_b):
    """loss relative difference, max|Δlogit|/max|logit|, max|Δgrad| over
    the global max|grad|, argmax agreement."""
    keys = [k for k in grads_b if not k.endswith(("running_mean",
                                                  "running_var"))]
    gsc = max(float(grads_b[k].abs().max()) for k in keys)
    return (abs(loss_a - loss_b) / abs(loss_b),
            float(np.abs(logits_a - logits_b).max() / np.abs(logits_b).max()),
            max(float((grads_a[k] - grads_b[k]).abs().max()) for k in keys)
            / gsc,
            float((logits_a.argmax(-1) == logits_b.argmax(-1)).mean()))


def test_qat_train_forward_backward_matches_jax(model_case):
    variables, perturbed, img, lab, wgt = model_case
    want = _jax_train(variables, img, lab, wgt)
    own = _spread(*_jax_train(perturbed, img, lab, wgt), *want)
    model = get_model("uresnet", state_dict_from_jax(variables), policy=QAT,
                      device="cpu", train=True)
    logits = model(torch.from_numpy(img), logits=True)
    loss = pixelwise_weighted_nll_from_logits(
        logits, torch.from_numpy(lab), torch.from_numpy(wgt))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    got = _spread(loss.item(), logits.detach().numpy(), grads, *want)
    assert got[0] <= 2 * own[0] and got[1] <= 2 * own[1], (got, own)
    assert got[2] <= 2 * own[2], (got, own)
    assert got[3] >= own[3] - 0.02, (got, own)


def _jax_eval(variables, img, policy):
    model = jax_get_model("uresnet", policy=policy, input_channels=1,
                          inplanes=16)
    return np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, train=False, logits=True))(variables, jnp.asarray(img)))


def test_qat_eval_matches_jax(model_case):
    """The validation forward of a QAT run (eval UResNet, running-stat
    BN), float32 under the gate of JAX's own spread, and float64 tight."""
    variables, perturbed, img, _, _ = model_case
    want = _jax_eval(variables, img, JAX_QAT)
    own = _jax_eval(perturbed, img, JAX_QAT)
    with torch.inference_mode():
        got = get_model("uresnet", state_dict_from_jax(variables),
                        policy=QAT, device="cpu")(torch.from_numpy(img),
                                                  logits=True).numpy()
    scale = np.abs(want).max()
    own_err = np.abs(own - want).max() / scale
    own_agree = (own.argmax(-1) == want.argmax(-1)).mean()
    assert np.abs(got - want).max() / scale <= 2 * own_err
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= own_agree - 0.02

    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda t: jnp.asarray(t, jnp.float64),
                                     variables)
        want64 = _jax_eval(v64, img.astype(np.float64), dataclasses.replace(
            JAX_QAT, param_dtype=jnp.float64, compute_dtype=jnp.float64,
            output_dtype=jnp.float64))
    assert want64.dtype == np.float64
    f64 = dataclasses.replace(QAT, compute_dtype=torch.float64,
                              output_dtype=torch.float64)
    with torch.inference_mode():
        got64 = get_model("uresnet", state_dict_from_jax(variables),
                          policy=f64, device="cpu")(
            torch.from_numpy(img).double(), logits=True).numpy()
    assert np.abs(got64 - want64).max() <= 1e-5 * np.abs(want64).max()
    assert (got64.argmax(-1) == want64.argmax(-1)).all()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_qat_needs_the_packed_zone(model_case, train):
    """A width that is no multiple of 2·p_stem = 16: JAX would run it
    unpacked, without QAT; the port raises."""
    variables = model_case[0]
    model = get_model("uresnet", state_dict_from_jax(variables), policy=QAT,
                      device="cpu", train=train)
    with pytest.raises(ValueError, match="QAT: input width 56"):
        model(torch.zeros(1, 64, 56, 1))
