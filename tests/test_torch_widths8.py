"""The UResNets at 8-channel streams (inplanes 8 and 4, 3 classes) in
the port against the JAX package, on the CPU: the widths the JAX
package supports and routes through its Pallas kernels at 8-channel
shapes. 32x32 crops (the zone's lane re-views need enc1's and dec1's
widths to divide by 16 at these streams), 64x64 for the train step (at
32x32 the train-mode BatchNorm of the 1x1 deepest stage normalises over
the batch's two pixels, and the f32 paths' few-ulp differences grow past
the logit bound), ``torch.set_num_threads(1)``.

Weights: seeded reference weights, imported by the JAX package
(deploy/importers.py), carried back through ``state_dict_from_jax``
into a reference ``.tar`` that the port loads. The port runs its
kernels' plain versions here (the card's kernels are held to those in
tests/test_torch_cuda.py). Tolerances, with what sets them — those of
tests/test_torch_widths.py:
  * eval under Policy.f32 (plain and kernel-zone forms): logits within
    1e-5·max|JAX| and equal argmax;
  * eval in bf16: the port's kernel zone against JAX's bf16 policy,
    each rounding to bf16 at its own layer boundaries: log-probabilities
    within 5e-2·max and argmax on ≥ 99% of pixels;
  * int8 against JAX's fused int8 (its Pallas kernels in interpret mode,
    the 8-channel ones among them) on the same calibrated scales: enc1,
    the int8 stage fed by the stem, within 1e-5·max of JAX's; the
    log-probabilities by argmax ≥ 0.999 (dec2's requantization turns a
    few-ulp difference of the f32 deep stages that straddles a midpoint
    into a whole int8 step);
  * one train-mode step, the zone form and the zone with the deconv-AD
    upsamples (fused_train_deconv), against JAX's value_and_grad under
    Policy.f32: logits within 1e-4·max, the loss at rtol 1e-5, every
    parameter gradient within 5e-2 of the global max |grad|;
  * each 8-channel kernel shape: the plain version against the JAX
    Pallas kernel in interpret mode at its lane pack, with
    tests/test_torch_kernels.py's and test_torch_widths.py's
    tolerances."""
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
from ubresnet_tpu.ops.packed import pack, tile_channel_vector, unpack
from ubresnet_tpu.ops.pallas_conv import (
    fused_basic_block,
    fused_dual_block,
    fused_packed_conv,
    fused_packed_deconv2x,
)
from ubresnet_tpu.ops.pallas_train import train_conv_stats as jax_tcs
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import (
    load_reference_checkpoint,
    random_state_dict,
    save_reference_checkpoint,
    state_dict_from_jax,
)
from ubresnet_tpu_torch.losses import pixelwise_weighted_nll_from_logits
from ubresnet_tpu_torch.models import TrainUResNet, UResNet
from ubresnet_tpu_torch.models.uresnet import zone_packs
from ubresnet_tpu_torch.ops import block as block_ops
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import deconv as deconv_ops
from ubresnet_tpu_torch.ops import train_conv as train_ops
from ubresnet_tpu_torch.ops.quant import calibrate

torch.set_num_threads(1)

HW = 32
F32_FUSED = dataclasses.replace(Policy.f32(), fused_eval=True)
F32_ZONE = dataclasses.replace(Policy.f32(), fused_train=True)
INT8_F32 = dataclasses.replace(Policy.f32(), fused_eval=True, quant_eval=True)
JAX_F32 = JaxPolicy(pack_width=8, compute_dtype=jnp.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


@pytest.fixture(scope="module", params=[8, 4], ids=["inplanes8",
                                                    "inplanes4"])
def config(request, tmp_path_factory):
    """(inplanes, JAX variables, the port's state_dict read back from
    the reference .tar)."""
    inplanes = request.param
    sd = random_state_dict(seed=3, inplanes=inplanes)
    variables = import_uresnet_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    path = tmp_path_factory.mktemp(f"p{inplanes}") / "ref.tar"
    save_reference_checkpoint(state_dict_from_jax(variables), str(path))
    port_sd, info = load_reference_checkpoint(str(path))
    assert info["inplanes"] == inplanes
    return inplanes, variables, port_sd


def _input(seed, b=2, hw=HW):
    rng = np.random.RandomState(seed)
    x = np.zeros((b, hw, hw, 1), np.float32)
    n = hw * hw // 8
    for i in range(b):
        x[i, rng.randint(0, hw, n), rng.randint(0, hw, n), 0] = (
            rng.rand(n) * 50 + 5)
    return x


def _jax_model(inplanes, policy):
    return jax_get_model("uresnet", policy=policy, input_channels=1,
                         inplanes=inplanes)


def _jax_eval(inplanes, variables, policy, x, logits=True):
    model = _jax_model(inplanes, policy)
    fwd = jax.jit(lambda v, x: model.apply(v, x, train=False, logits=logits))
    return np.asarray(fwd(variables, jnp.asarray(x))).astype(np.float32)


_F32_WANT = {}  # JAX's f32 logits per width, shared by both port forms


@pytest.mark.parametrize("policy", [Policy.f32(), F32_FUSED],
                         ids=["f32", "f32-zone"])
def test_eval_f32_matches_jax(config, policy):
    inplanes, variables, sd = config
    x = _input(1)
    if inplanes not in _F32_WANT:
        _F32_WANT[inplanes] = _jax_eval(inplanes, variables,
                                        JaxPolicy.f32(), x)
    want = _F32_WANT[inplanes]
    with torch.inference_mode():
        got = UResNet(sd, policy=policy, device="cpu")(
            torch.from_numpy(x), logits=True).numpy()
    assert got.shape == want.shape == (2, HW, HW, 3)
    assert float(np.abs(got - want).max()) <= 1e-5 * float(
        np.abs(want).max())
    assert float((got.argmax(-1) == want.argmax(-1)).mean()) == 1.0


def test_eval_bf16_matches_jax(config):
    inplanes, variables, sd = config
    x = _input(2)
    want = _jax_eval(inplanes, variables, JaxPolicy.bf16(), x, logits=False)
    model = UResNet(sd, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).float().numpy()
    err = float(np.abs(got - want).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"inplanes {inplanes}: bf16 max |Δ log p| {err} of "
          f"{float(np.abs(want).max())}; argmax {agree}")
    assert err <= 5e-2 * float(np.abs(want).max())
    assert agree >= 0.99


def test_int8_matches_jax(config):
    inplanes, variables, sd = config
    x = _input(3)
    m = UResNet(sd, policy=INT8_F32, device="cpu")
    scales = calibrate(m, [x])
    m.set_quant_scales(scales)
    quant = {}
    for name, v in scales.items():
        node = quant
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["act_scale"] = jnp.float32(float(v))
    jq = dataclasses.replace(JAX_F32, quant_eval=True, fused_eval=True)
    model = _jax_model(inplanes, jq)
    fwd = jax.jit(lambda v, x: model.apply(
        v, x, train=False, capture_intermediates=True,
        mutable=["intermediates"]))
    want, inter = fwd(dict(variables, quant=quant), jnp.asarray(x))
    want = np.asarray(want)
    enc1 = np.asarray(unpack(inter["intermediates"]["enc1"]["__call__"][0],
                             zone_packs(m.config)["enc1"]))
    got_enc1 = {}
    m.enc[0].register_forward_hook(
        lambda mod, a, out: got_enc1.setdefault("y", out))
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    d1 = float(np.abs(got_enc1["y"].numpy() - enc1).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"inplanes {inplanes}: int8 enc1 max |Δ| {d1} of "
          f"{np.abs(enc1).max()}; argmax {agree}")
    assert d1 <= 1e-5 * float(np.abs(enc1).max())
    assert agree >= 0.999


@pytest.mark.parametrize("deconv_ad", [False, True], ids=["zone",
                                                          "deconv-ad"])
def test_train_step_matches_jax(config, deconv_ad):
    inplanes, variables, sd = config
    rng = np.random.RandomState(4)
    hw = 2 * HW
    x = _input(4, hw=hw)
    lab = rng.randint(0, 3, (2, hw, hw)).astype(np.int32)
    wgt = (rng.rand(2, hw, hw) + 0.5).astype(np.float32)
    model = _jax_model(inplanes, JaxPolicy.f32())

    @jax.jit
    def run(params):
        def loss(p):
            out, _ = model.apply(
                {"params": p, "batch_stats": variables["batch_stats"]},
                jnp.asarray(x), train=True, logits=True,
                mutable=["batch_stats"])
            return jax_nll(out, lab, wgt), out

        return jax.value_and_grad(loss, has_aux=True)(params)

    (want_loss, want_logits), grads = run(variables["params"])
    want_g = state_dict_from_jax({"params": grads,
                                  "batch_stats": variables["batch_stats"]})
    pol = dataclasses.replace(F32_ZONE, fused_train_deconv=deconv_ad)
    port = TrainUResNet(sd, policy=pol, device="cpu").train()
    # the train zone's convs (K5 16 or 10 and the classifier) and, with
    # the flag, dec2's and dec1's upsamples on the deconv-AD kernels
    assert sum(m.zone for m in port.modules() if hasattr(m, "zone")) == (
        17 if inplanes == 8 else 11)
    assert sum(m.ad for m in port.modules() if hasattr(m, "ad")) == (
        2 if deconv_ad else 0)
    logits = port(torch.from_numpy(x), logits=True)
    loss = pixelwise_weighted_nll_from_logits(
        logits, torch.from_numpy(lab), torch.from_numpy(wgt))
    loss.backward()
    want_logits = np.asarray(want_logits)
    assert float(np.abs(logits.detach().numpy() - want_logits).max()) <= (
        1e-4 * float(np.abs(want_logits).max()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got_g = {n: p.grad for n, p in port.named_parameters()}
    scale = max(float(want_g[n].abs().max()) for n in got_g)
    worst = max(float((got_g[n] - want_g[n]).abs().max()) for n in got_g)
    print(f"inplanes {inplanes}, deconv AD {deconv_ad}: grad max |Δ| "
          f"{worst} of {scale}")
    assert worst <= 5e-2 * scale


def _affine(rng, co):
    return ((rng.rand(co) + 0.5).astype(np.float32),
            (rng.randn(co) * 0.1).astype(np.float32))


@pytest.mark.parametrize("ca,cb,co,proj", [(8, 0, 16, True),
                                           (8, 8, 8, True),
                                           (8, 0, 8, False)])
def test_block_shapes_match_pallas(ca, cb, co, proj):
    """K2's 8-channel instances (enc1.res1 at 8; dec1.res1, dual; the
    8-channel res2 blocks), plain version ≡ fused_basic_block /
    fused_dual_block in interpret mode at the lane pack 16."""
    rng = np.random.RandomState(ca + cb + co)
    p, cin = 128 // ca, ca + cb
    a = np.abs(rng.randn(2, 8, 4 * p, ca)).astype(np.float32)
    b = np.abs(rng.randn(2, 8, 4 * p, cb)).astype(np.float32) if cb else None
    w1 = (rng.randn(3, 3, cin, co) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, co, co) * 0.1).astype(np.float32)
    wb = (rng.randn(1, 1, cin, co) * 0.1).astype(np.float32)
    (g1, b1), (g2, b2), (gb, bb) = (_affine(rng, co) for _ in range(3))
    j, tcv = jnp.asarray, tile_channel_vector
    aff = [tcv(j(v), p) for v in (g1, b1, g2, b2, gb, bb)]
    if cb:
        want = fused_dual_block(pack(j(a), p), pack(j(b), p), j(w1), aff[0],
                                aff[1], j(w2), aff[2], aff[3], j(wb), aff[4],
                                aff[5], p=p, th=4, interpret=True)
    else:
        want = fused_basic_block(
            pack(j(a), p), j(w1), aff[0], aff[1], j(w2), aff[2], aff[3],
            j(wb) if proj else None, aff[4] if proj else None,
            aff[5] if proj else None, p=p, th=4, interpret=True)
    got = block_ops.basic_block(
        _t(a), None if b is None else _t(b), _t(w1), _t(g1), _t(b1), _t(w2),
        _t(g2), _t(b2), _t(wb[0, 0]) if proj else None,
        _t(gb) if proj else None, _t(bb) if proj else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(unpack(want, p)),
                               atol=2e-4)


@pytest.mark.parametrize("ci,co,k", [(8, 16, 7), (8, 8, 3), (8, 4, 3),
                                     (8, 4, 1)])
def test_conv_shapes_match_pallas(ci, co, k):
    """K1's 8-channel eval instances (the inplanes-8 head conv10; at 4
    enc1.res1's cb2, dec1.res1's cb1 and its projection), plain version
    with a residual ≡ fused_packed_conv in interpret mode at pack 16."""
    rng = np.random.RandomState(ci + co + k)
    p = 128 // ci
    x = np.abs(rng.randn(2, 16, 4 * p, ci)).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    g, b = _affine(rng, co)
    res = rng.randn(2, 16, 4 * p, co).astype(np.float32)
    j = jnp.asarray
    want = unpack(fused_packed_conv(
        pack(j(x), p), j(w), tile_channel_vector(j(g), p),
        tile_channel_vector(j(b), p), p=p, residual=pack(j(res), p),
        pre_act=True, th=4, interpret=True), p)
    got = conv_ops.conv_bn_act(_t(x), _t(w), _t(g), _t(b), _t(res),
                               pre_act=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("ci,co", [(16, 8), (8, 4)])
def test_deconv_shapes_match_pallas(ci, co):
    """K3's 8-channel instances (dec1 at 8; dec2 and dec1 at 4), plain
    version ≡ fused_packed_deconv2x in interpret mode at pack 128/ci."""
    rng = np.random.RandomState(ci + co)
    p = 128 // ci
    x = rng.randn(2, 8, 4 * p, ci).astype(np.float32)
    w = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    want = unpack(fused_packed_deconv2x(pack(jnp.asarray(x), p),
                                        jnp.asarray(w), p=p, th=4,
                                        interpret=True), p)
    got = deconv_ops.deconv2x(_t(x), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("ci,co,k", [(8, 16, 3), (8, 16, 1), (8, 16, 7),
                                     (16, 8, 3), (16, 8, 1), (8, 8, 3),
                                     (8, 4, 3), (8, 4, 1)])
def test_train_shapes_match_pallas(ci, co, k):
    """The train zone's 8-channel shapes: K5 forward and sums, and
    through its VJP K1 at the transposed shape (dx) and K6 (dW), plain
    versions ≡ train_conv_stats in interpret mode at the lane pack."""
    rng = np.random.RandomState(ci + co + k)
    p = 128 // ci
    x = rng.randn(2, 8, 4 * p, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    r = rng.randn(2, 8, 4 * p, co).astype(np.float32)
    c1 = rng.randn(co).astype(np.float32)
    c2 = (rng.randn(co) * 0.01).astype(np.float32)
    r_p, c1_p, c2_p = pack(jnp.asarray(r), p), jnp.tile(c1, p), jnp.tile(c2, p)

    def loss_jax(x, w, b):
        y, s1, s2 = jax_tcs(x, w, b, p, True)
        return jnp.sum(y * r_p) + jnp.sum(s1 * c1_p) + jnp.sum(s2 * c2_p)

    want_loss, want_g = jax.value_and_grad(loss_jax, (0, 1, 2))(
        pack(jnp.asarray(x), p), jnp.asarray(w), jnp.asarray(b))
    y_j, s1_j, s2_j = jax_tcs(pack(jnp.asarray(x), p), jnp.asarray(w),
                              jnp.asarray(b), p, True)
    tx, tw, tb = _t(x, True), _t(w, True), _t(b, True)
    y, s1, s2 = train_ops.train_conv_stats(tx, tw, tb)
    loss = (y * _t(r)).sum() + (s1 * _t(c1)).sum() + (s2 * _t(c2)).sum()
    loss.backward()

    def close(got, want, rtol, atol):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=rtol, atol=atol)

    close(y.detach(), unpack(y_j, p), 1e-5, 1e-5)
    close(s1.detach(), s1_j.reshape(p, co).sum(0), 1e-4, 1e-3)
    close(s2.detach(), s2_j.reshape(p, co).sum(0), 1e-4, 1e-3)
    close(loss.item(), float(want_loss), 2e-4, 0.0)
    close(tx.grad, unpack(want_g[0], p), 1e-4, 1e-4)
    close(tw.grad, want_g[1], 1e-4, 1e-3)
    close(tb.grad, want_g[2], 1e-4, 1e-3)
