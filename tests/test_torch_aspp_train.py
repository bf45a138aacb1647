"""Training the port's ASPP-ResNet (TrainASPPResNet) against the JAX
package's ASPPResNet in train mode, float32 on the CPU, at 64x64,
batch 2: forward and backward, the BN running stats, remat and QAT.

Weights: test_torch_aspp.py's — JAX's ``model.init`` with seeded BN
statistics, affines and conv biases — crossing over through
``state_dict_from_jax``. Tolerances, as tests/test_torch_train.py holds
the UResNet and for the same reasons (train-mode BN makes f32 rounding
matter; ROADMAP.md §3): logits within 1e-4·max of JAX's and 2e-5·max
of the same network in float64, the loss at rtol 1e-5, running stats
within 5e-5·max|stat| of JAX's and 1e-5 of float64, every parameter
gradient within 5e-2 of the global max |grad|. The zone form also runs
at inplanes 4, where the dilated branches' (32, 16, 3) is in K5's table.

Remat recomputes each stage, ASPP and recompression in backward and
changes no arithmetic: loss, gradients and stats bit-equal to no remat,
the stats moved once. QAT: the model under twice JAX's own spread when
its weights move by 1e-6 (test_torch_qat.py's gate), the eval forward in
float64 within 1e-5·max; per layer, every fake-quantized input is read
at JAX's pack, 8 (UResNet packs enc1 and dec2 at 4), which decides the
percentile's strided subsample above 2^20 elements: bit-exact against
JAX's fake_quant_act on the packed tensor."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aspp import jax_aspp, jax_variables
from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.losses import pixelwise_weighted_nll_from_logits as jax_nll
from ubresnet_tpu.ops import quant as jq
from ubresnet_tpu.ops.packed import pack, unpack
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import (
    random_state_dict,
    state_dict_from_jax,
)
from ubresnet_tpu_torch.losses import pixelwise_weighted_nll_from_logits
from ubresnet_tpu_torch.models import (
    ASPPResNet,
    TrainASPPResNet,
    TrainUResNet,
    blocks,
    get_model,
)
from ubresnet_tpu_torch.ops import quant
from ubresnet_tpu_torch.ops.loss import weighted_nll
from ubresnet_tpu_torch.train import optimizers as port_opt
from ubresnet_tpu_torch.train.step import (
    build_eval_step,
    build_train_step,
    create_train_state,
)

torch.set_num_threads(1)

F32 = Policy.f32()
F32_ZONE = dataclasses.replace(Policy.f32(), fused_train=True)
QAT = dataclasses.replace(Policy.f32(), quant_train=True)
JAX_QAT = JaxPolicy(pack_width=8, compute_dtype=jnp.float32,
                    quant_train=True)
GRAD_FLOOR = 5e-2
_VARIABLES = {}


def _variables(p):
    if p not in _VARIABLES:
        _VARIABLES[p] = jax_variables(p)
    return _VARIABLES[p]


def _batch(seed, b=2, hw=64):
    """Sparse ADC-like crop with class labels on the hits and class-
    balancing-like weights."""
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


_JAX_STEPS = {}


def _jax_train(variables, batch, p=16, policy=None):
    """JAX loss, logits, and the gradients and updated stats as a
    reference state_dict, of one train-mode forward and backward (one
    compile per width and policy)."""
    key = (p, policy)
    if key not in _JAX_STEPS:
        model = jax_aspp(p, policy)

        @jax.jit
        def run(params, stats, img, lab, wgt):
            def loss(prm):
                out, upd = model.apply(
                    {"params": prm, "batch_stats": stats}, img, train=True,
                    logits=True, mutable=["batch_stats"])
                return jax_nll(out, lab, wgt), (out, upd)

            return jax.value_and_grad(loss, has_aux=True)(params)

        _JAX_STEPS[key] = run
    (loss, (logits, upd)), grads = _JAX_STEPS[key](
        variables["params"], variables["batch_stats"],
        *(jnp.asarray(batch[k]) for k in ("image", "label", "weight")))
    return float(loss), np.array(logits), state_dict_from_jax(
        {"params": grads, "batch_stats": upd["batch_stats"]})


_JAX_RESULTS = {}


def _jax_result(p):
    if p not in _JAX_RESULTS:
        _JAX_RESULTS[p] = _jax_train(_variables(p), _batch(1), p)
    return _JAX_RESULTS[p]


def _assert_stats(got_sd, want_sd, tol):
    keys = [k for k in want_sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 67  # UResNet's 52 BNs and ASPP's 15
    for k in keys:
        want = want_sd[k].double()
        err = float((got_sd[k].double() - want).abs().max())
        assert err <= tol * float(want.abs().max()), (k, err)


@pytest.mark.parametrize("p,policy", [(16, F32), (16, F32_ZONE),
                                      (4, F32_ZONE)],
                         ids=["p16-plain", "p16-zone", "p4-zone"])
def test_train_forward_backward_matches_jax(p, policy):
    """Train-mode logits, BN running-stat updates and every parameter
    gradient ≡ JAX; the zone form runs the kernels' plain versions (K5,
    conv_ad, the pool AD, the loss kernel's)."""
    variables = _variables(p)
    want_loss, want_logits, want = _jax_result(p)
    batch = _batch(1)
    model = get_model("aspp_resnet", state_dict_from_jax(variables),
                      policy=policy, device="cpu", train=True)
    logits = model(torch.from_numpy(batch["image"]), logits=True)
    lab, wgt = (torch.from_numpy(batch[k]) for k in ("label", "weight"))
    loss = (weighted_nll(logits, lab, wgt) if policy.fused_train
            else pixelwise_weighted_nll_from_logits(logits, lab, wgt))
    loss.backward()
    f64 = Policy(compute_dtype=torch.float64, output_dtype=torch.float64,
                 fused_eval=False, fused_train=False)
    exact = get_model("aspp_resnet", state_dict_from_jax(variables),
                      policy=f64, device="cpu", train=True).double()
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
    for k, prm in grads.items():
        err = float((prm.grad - want[k]).abs().max())
        assert err < GRAD_FLOOR * gsc, (k, err, gsc)


def _sgd_steps(sd, policy, steps=2):
    """[(metrics, {param grad}, state_dict)] after each SGD step."""
    model = get_model("aspp_resnet", sd, policy=policy, device="cpu",
                      train=True)
    opt = port_opt.make_optimizer(model.parameters(), "sgd", 1e-2,
                                  weight_decay=1e-3, momentum=0.9)
    step = build_train_step(num_classes=3, use_pallas_loss=policy.fused_train,
                            device="cpu")
    state = create_train_state(model, opt)
    out = []
    for i in range(steps):
        state, metrics = step(state, _batch(2 + i))
        out.append((metrics,
                    {k: q.grad.clone() for k, q in model.named_parameters()},
                    {k: v.clone() for k, v in model.state_dict().items()}))
    return out


def test_remat_is_bit_equal_to_no_remat():
    """Policy.remat (each encoder, ASPP, recompression and decoder stage
    recomputed in backward) against no remat, two SGD steps: metrics,
    gradients, parameters and running stats bit for bit — so the stats
    moved once a step, not again in the recompute."""
    sd = state_dict_from_jax(_variables(16))
    plain = _sgd_steps(sd, F32_ZONE)
    rem = _sgd_steps(sd, dataclasses.replace(F32_ZONE, remat=True))
    bad = []
    for i, ((gm, gg, gs), (wm, wg, ws)) in enumerate(zip(rem, plain)):
        bad += [f"{i}:metric:{k}" for k in wm if gm[k] != wm[k]]
        bad += [f"{i}:grad:{k}" for k in wg if not torch.equal(gg[k], wg[k])]
        bad += [f"{i}:state:{k}" for k in ws if not torch.equal(gs[k], ws[k])]
    assert bad == []
    # the stats moved: once a step, by the batch moments
    k = "ASPP_layer_enc4.B3_bn.running_var"
    assert not torch.equal(rem[0][2][k], sd[k])


def test_remat_recomputes_every_aspp_stage(monkeypatch):
    """Under Policy.remat the forward hands each of the 5 encoder, 3
    ASPP, 3 recompression and 5 decoder stages to remat."""
    called = []
    real = blocks.remat

    def spy(module, *args, **kw):
        called.append(type(module).__name__)
        return real(module, *args, **kw)

    from ubresnet_tpu_torch.models import uresnet

    monkeypatch.setattr(uresnet, "remat", spy)
    sd = random_state_dict(seed=0, inplanes=4, arch="aspp_resnet")
    model = TrainASPPResNet(sd, policy=dataclasses.replace(F32, remat=True),
                            device="cpu")
    model(torch.zeros(1, 64, 64, 1)).sum().backward()
    assert sorted(called) == sorted(
        ["TrainDoubleResNet"] * 5 + ["TrainASPP"] * 3
        + ["TrainASPPCombine"] * 3 + ["TrainDecoderBlock"] * 5)


def test_eval_step_builds_the_paired_eval_model():
    """The trainer's validation step builds the eval class the registry
    pairs with the trained model's class: an ASPPResNet with the live
    weights, whose logits it scores."""
    sd = random_state_dict(seed=0, inplanes=4, arch="aspp_resnet")
    model = get_model("aspp_resnet", sd, policy=F32, device="cpu",
                      train=True)
    state = create_train_state(model, port_opt.make_optimizer(
        model.parameters(), "adam", 1e-3))
    batch = _batch(5)
    metrics = build_eval_step(device="cpu")(state, batch)
    with torch.inference_mode():
        logits = ASPPResNet(sd, policy=F32, device="cpu")(
            torch.from_numpy(batch["image"]), logits=True)
        want = pixelwise_weighted_nll_from_logits(
            logits, torch.from_numpy(batch["label"]),
            torch.from_numpy(batch["weight"]))
    assert metrics["loss"] == pytest.approx(want.item(), rel=1e-6)


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


def _perturbed(variables, seed):
    noise = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda t: t * (1 + 1e-6 * noise.randn(*np.shape(t))
                       .astype(np.float32)), variables)


@pytest.fixture(scope="module")
def qat_case():
    variables = _variables(16)
    return variables, _perturbed(variables, 3), _batch(1)


def test_qat_train_forward_backward_matches_jax(qat_case):
    """The QAT train step's loss, logits and gradients within twice
    JAX's own spread under 1e-6 weight noise (argmax within 2% of it).
    The spread of one draw varies by 10x (its loss 1.3e-5 to 1.3e-3 over
    seeds 3 and 10-13 here), so JAX's own is the largest of three draws
    (the smallest argmax agreement)."""
    variables, _, batch = qat_case
    want = _jax_train(variables, batch, policy=JAX_QAT)
    draws = [_spread(*_jax_train(_perturbed(variables, seed), batch,
                                 policy=JAX_QAT), *want)
             for seed in (3, 4, 5)]
    own = tuple(max(d[i] for d in draws) for i in range(3)) + (
        min(d[3] for d in draws),)
    model = get_model("aspp_resnet", state_dict_from_jax(variables),
                      policy=QAT, device="cpu", train=True)
    logits = model(torch.from_numpy(batch["image"]), logits=True)
    loss = pixelwise_weighted_nll_from_logits(
        logits, torch.from_numpy(batch["label"]),
        torch.from_numpy(batch["weight"]))
    loss.backward()
    grads = {k: q.grad for k, q in model.named_parameters()}
    got = _spread(loss.item(), logits.detach().numpy(), grads, *want)
    assert got[0] <= 2 * own[0] and got[1] <= 2 * own[1], (got, own)
    assert got[2] <= 2 * own[2], (got, own)
    assert got[3] >= own[3] - 0.02, (got, own)


_JAX_EVALS = {}


def _jax_eval(variables, img, policy):
    """JAX's eval logits (one jitted forward per policy: the weights and
    their perturbed copy share it)."""
    if policy not in _JAX_EVALS:
        _JAX_EVALS[policy] = jax.jit(lambda v, x: jax_aspp(16, policy).apply(
            v, x, train=False, logits=True))
    return np.asarray(_JAX_EVALS[policy](variables, jnp.asarray(img)))


def test_qat_eval_matches_jax(qat_case):
    """The validation forward of a QAT run (eval ASPPResNet), float32
    under the gate of JAX's own spread, and float64 tight."""
    variables, perturbed, batch = qat_case
    img = batch["image"]
    want = _jax_eval(variables, img, JAX_QAT)
    own = _jax_eval(perturbed, img, JAX_QAT)
    with torch.inference_mode():
        got = get_model("aspp_resnet", state_dict_from_jax(variables),
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
        got64 = get_model("aspp_resnet", state_dict_from_jax(variables),
                          policy=f64, device="cpu")(
            torch.from_numpy(img).double(), logits=True).numpy()
    assert np.abs(got64 - want64).max() <= 1e-5 * np.abs(want64).max()
    assert (got64.argmax(-1) == want64.argmax(-1)).all()


def test_qat_layers_read_their_input_at_jax_pack():
    """Per layer: QAT fake-quantizes exactly JAX's packed zone (stem,
    enc1, dec2, dec1, head, the classifier's kernel), each input at pack
    8. At percentile 99.9 on a (1, 512, 512, 16) input — above the
    2^20-element cap, so the subsample strides the packed W axis — the
    port's fake_quant_act at the layer's pack is JAX's on the packed
    tensor bit for bit, where UResNet's pack 4 gives other bits."""
    sd = random_state_dict(seed=0, arch="aspp_resnet")
    model = TrainASPPResNet(sd, policy=QAT, device="cpu")
    qat = {n: m.qpack for n, m in model.named_modules()
           if isinstance(m, (blocks.Conv, blocks.TrainDeconv2x)) and m.qat}
    zone = ("conv1", "enc_layer1.", "dec_layer2.", "dec_layer1.", "conv10",
            "conv11")
    assert qat and all(n.startswith(zone) for n in qat)
    assert len(qat) == 1 + 5 + 2 * 6 + 2
    # the classifier fake-quantizes its kernel only
    assert {pk for n, pk in qat.items() if n != "conv11"} == {8}
    uresnet = TrainUResNet(random_state_dict(seed=0), policy=QAT,
                           device="cpu")
    assert uresnet.enc_layer1.res1.conv1.qpack == 4  # the trap

    rng = np.random.RandomState(4)
    x = np.maximum(rng.randn(1, 512, 512, 16), 0).astype(np.float32)
    x *= rng.rand(1, 512, 512, 1).astype(np.float32) * 3
    want = np.asarray(unpack(jax.jit(jq.fake_quant_act, static_argnums=1)(
        pack(jnp.asarray(x), 8), 99.9), 8))
    pk = model.enc_layer1.res1.conv1.qpack
    got = quant.fake_quant_act(torch.from_numpy(x), 99.9, pk).numpy()
    np.testing.assert_array_equal(got, want)
    other = quant.fake_quant_act(torch.from_numpy(x), 99.9, 4).numpy()
    assert not np.array_equal(other, want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_qat_needs_the_packed_zone(train):
    """A width that is no multiple of 16: JAX's ASPP would run it
    unpacked, without QAT; the port raises. At 80 JAX packs and then
    raises, as dec2's input (width 20) does not pack at 8; so does the
    port. 96 runs: no depth condition, that is UResNet's."""
    sd = random_state_dict(seed=0, inplanes=4, arch="aspp_resnet")
    model = get_model("aspp_resnet", sd, policy=QAT, device="cpu",
                      train=train)
    with pytest.raises(ValueError, match="QAT: input width 56"):
        model(torch.zeros(1, 64, 56, 1))
    with pytest.raises(ValueError, match="width 20, at 8"):
        model(torch.zeros(1, 64, 80, 1))
    with torch.no_grad():
        assert model(torch.zeros(1, 64, 96, 1)).shape == (1, 64, 96, 3)
