"""The reference's two other UResNets in the port against the JAX
package, on the CPU: the trainer's (inplanes 32, 3 classes,
final_conv_kernels 16) and the precropped deploy's (inplanes 16, 4
classes). 64x64 crops, ``torch.set_num_threads(1)``.

Weights: seeded reference weights, imported by the JAX package
(deploy/importers.py), carried back through ``state_dict_from_jax``
into a reference ``.tar`` that the port loads
(``load_reference_checkpoint``). Tolerances, with what sets them:
  * eval under Policy.f32 (plain and kernel-zone forms, the kernels'
    plain versions here): logits within 1e-5·max|JAX| and equal argmax,
    as tests/test_torch_model.py;
  * eval in bf16: the port's kernel zone against JAX's bf16 policy, each
    rounding to bf16 at its own layer boundaries (2^-8 relative each, a
    few dozen of them): log-probabilities within 5e-2·max and argmax on
    ≥ 99% of pixels;
  * int8 against JAX's one-device fused int8 on the same calibrated
    scales: exact integer sums and float32 epilogues in both. enc1, the
    int8 stage fed by the stem, within 1e-5·max of JAX's (captured
    intermediates). Past it the f32 deep stages (enc2-dec3, outside the
    int8 zone) sit a few ulps from JAX's (1e-3 of 594 at dec5 here), and
    dec2's input requantization turns every such difference that
    straddles a rounding midpoint into a whole int8 step, which the
    random weights (logits ~1e4) magnify: the log-probabilities are held
    by argmax ≥ 0.999 (measured 0.99976 and 0.99988);
  * one train-mode step against JAX's value_and_grad under Policy.f32
    (the zone form, fused_train): logits within 1e-4·max and the loss
    at rtol 1e-5 (ROADMAP "Limits of the comparison"), every parameter
    gradient within 5e-2 of the global max |grad|, the JAX package's own
    floor for f32 BN-train gradients (tests/test_torch_train.py; measured
    here 1.2e-2 and 1.6e-2, the spread the flagship shows there);
  * each new kernel shape: the plain version against the JAX Pallas
    kernel in interpret mode at 16x16, with tests/test_torch_kernels.py's
    and test_torch_train_kernels.py's tolerances;
  * the 4-class precropped CLI against the JAX CLI (float32, tame
    classifier): four score images an event, equal within 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.cli.infer_precropped import main as jax_cli
from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import import_uresnet_state_dict
from ubresnet_tpu.losses import pixelwise_weighted_nll_from_logits as jax_nll
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu.ops.packed import pack, tile_channel_vector, unpack
from ubresnet_tpu.ops.pallas_conv import (
    fused_basic_block,
    fused_dual_block,
    fused_packed_conv,
    pallas_conv_ad,
)
from ubresnet_tpu.ops.pallas_train import train_conv_stats as jax_tcs
from ubresnet_tpu_torch.cli.infer_precropped import main as port_cli
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader
from ubresnet_tpu_torch.deploy.weights import (
    load_reference_checkpoint,
    random_state_dict,
    save_reference_checkpoint,
    state_dict_from_jax,
)
from ubresnet_tpu_torch.losses import pixelwise_weighted_nll_from_logits
from ubresnet_tpu_torch.models import TrainUResNet, UResNet
from ubresnet_tpu_torch.ops import block as block_ops
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import train_conv as train_ops
from ubresnet_tpu_torch.ops.quant import calibrate

torch.set_num_threads(1)

HW = 64
CONFIGS = {"inplanes32": (32, 3), "classes4": (16, 4)}
F32_FUSED = dataclasses.replace(Policy.f32(), fused_eval=True)
F32_ZONE = dataclasses.replace(Policy.f32(), fused_train=True)
INT8_F32 = dataclasses.replace(Policy.f32(), fused_eval=True, quant_eval=True)
JAX_F32 = JaxPolicy(pack_width=8, compute_dtype=jnp.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def config(request, tmp_path_factory):
    """(inplanes, classes, JAX variables, the port's state_dict read
    back from the reference .tar)."""
    inplanes, classes = CONFIGS[request.param]
    sd = random_state_dict(seed=3, inplanes=inplanes, num_classes=classes)
    variables = import_uresnet_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    path = tmp_path_factory.mktemp(request.param) / "ref.tar"
    save_reference_checkpoint(state_dict_from_jax(variables), str(path))
    port_sd, info = load_reference_checkpoint(str(path))
    assert (info["inplanes"], info["num_classes"]) == (inplanes, classes)
    return inplanes, classes, variables, port_sd


def _input(seed, b=2):
    rng = np.random.RandomState(seed)
    x = np.zeros((b, HW, HW, 1), np.float32)
    n = HW * HW // 8
    for i in range(b):
        x[i, rng.randint(0, HW, n), rng.randint(0, HW, n), 0] = (
            rng.rand(n) * 50 + 5)
    return x


def _jax_model(inplanes, classes, policy):
    return jax_get_model("uresnet", policy=policy, input_channels=1,
                         inplanes=inplanes, num_classes=classes)


def _jax_eval(config, policy, x, variables=None, logits=True):
    inplanes, classes, v, _ = config
    model = _jax_model(inplanes, classes, policy)
    fwd = jax.jit(lambda v, x: model.apply(v, x, train=False, logits=logits))
    return np.asarray(fwd(v if variables is None else variables,
                          jnp.asarray(x))).astype(np.float32)


_F32_WANT = {}  # JAX's f32 logits per config, shared by both port forms


@pytest.mark.parametrize("policy", [Policy.f32(), F32_FUSED],
                         ids=["f32", "f32-zone"])
def test_eval_f32_matches_jax(config, policy):
    inplanes, classes, _, sd = config
    x = _input(1)
    if config[:2] not in _F32_WANT:
        _F32_WANT[config[:2]] = _jax_eval(config, JaxPolicy.f32(), x)
    want = _F32_WANT[config[:2]]
    with torch.inference_mode():
        got = UResNet(sd, policy=policy, device="cpu")(
            torch.from_numpy(x), logits=True).numpy()
    assert got.shape == want.shape == (2, HW, HW, classes)
    assert float(np.abs(got - want).max()) <= 1e-5 * float(
        np.abs(want).max())
    assert float((got.argmax(-1) == want.argmax(-1)).mean()) == 1.0


def test_eval_bf16_matches_jax(config):
    inplanes, classes, _, sd = config
    x = _input(2)
    want = _jax_eval(config, JaxPolicy.bf16(), x, logits=False)
    with torch.inference_mode():
        got = UResNet(sd, device="cpu")(torch.from_numpy(x)).float().numpy()
    err = float(np.abs(got - want).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"inplanes {inplanes}, {classes} classes: bf16 max |Δ log p| "
          f"{err} of {float(np.abs(want).max())}; argmax {agree}")
    assert err <= 5e-2 * float(np.abs(want).max())
    assert agree >= 0.99


def test_int8_matches_jax(config):
    inplanes, classes, variables, sd = config
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
    model = _jax_model(inplanes, classes, jq)
    fwd = jax.jit(lambda v, x: model.apply(
        v, x, train=False, capture_intermediates=True,
        mutable=["intermediates"]))
    want, inter = fwd(dict(variables, quant=quant), jnp.asarray(x))
    want = np.asarray(want)
    enc1 = np.asarray(unpack(inter["intermediates"]["enc1"]["__call__"][0],
                             128 // (2 * inplanes)))
    got_enc1 = {}
    m.enc[0].register_forward_hook(
        lambda mod, a, out: got_enc1.setdefault("y", out))
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    d1 = float(np.abs(got_enc1["y"].numpy() - enc1).max())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"inplanes {inplanes}, {classes} classes: int8 enc1 max |Δ| {d1} "
          f"of {np.abs(enc1).max()}; argmax {agree}")
    assert d1 <= 1e-5 * float(np.abs(enc1).max())
    assert agree >= 0.999


def test_train_step_matches_jax(config):
    inplanes, classes, variables, sd = config
    rng = np.random.RandomState(4)
    x = _input(4)
    lab = rng.randint(0, classes, (2, HW, HW)).astype(np.int32)
    wgt = (rng.rand(2, HW, HW) + 0.5).astype(np.float32)
    model = _jax_model(inplanes, classes, JaxPolicy.f32())

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
    port = TrainUResNet(sd, policy=F32_ZONE, device="cpu").train()
    assert sum(m.zone for m in port.modules() if hasattr(m, "zone")) == (
        15 if inplanes == 32 else 17)
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
    print(f"inplanes {inplanes}, {classes} classes: grad max |Δ| {worst} "
          f"of {scale}")
    assert worst <= 5e-2 * scale


def _affine(rng, co):
    return ((rng.rand(co) + 0.5).astype(np.float32),
            (rng.randn(co) * 0.1).astype(np.float32))


@pytest.mark.parametrize("ca,cb,co,proj", [(32, 0, 64, True),
                                           (64, 0, 64, False),
                                           (64, 64, 64, True)])
def test_new_block_shapes_match_pallas(ca, cb, co, proj):
    """K2's inplanes-32 instances (enc1.res1; enc1.res2 and dec2.res2;
    dec2.res1, dual), plain version ≡ fused_basic_block /
    fused_dual_block in interpret mode at the lane pack 128 / ca."""
    rng = np.random.RandomState(ca + cb + co)
    p, cin = 128 // ca, ca + cb
    a = np.abs(rng.randn(2, 16, 16, ca)).astype(np.float32)
    b = np.abs(rng.randn(2, 16, 16, cb)).astype(np.float32) if cb else None
    w1 = (rng.randn(3, 3, cin, co) * 0.05).astype(np.float32)
    w2 = (rng.randn(3, 3, co, co) * 0.05).astype(np.float32)
    wb = (rng.randn(1, 1, cin, co) * 0.05).astype(np.float32)
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


def test_four_class_classifier_matches_pallas():
    """K1 at the 4-class classifier (16, 4, 7): the eval form (g = 1,
    b = bias, no ReLU) ≡ fused_packed_conv, and conv_ad (K1 forward,
    K1 dx at (4, 16, 7), K6 dW at (16, 4, 7)) ≡ pallas_conv_ad."""
    rng = np.random.RandomState(6)
    p = 8
    x = rng.randn(2, 16, 16, 16).astype(np.float32)
    w = (rng.randn(7, 7, 16, 4) * 0.1).astype(np.float32)
    bias = (rng.randn(4) * 0.1).astype(np.float32)
    want = unpack(fused_packed_conv(
        pack(jnp.asarray(x), p), jnp.asarray(w), jnp.ones(4 * p),
        jnp.tile(jnp.asarray(bias), p), p=p, act=False, th=4,
        interpret=True), p)
    got = conv_ops.conv_bn_act(_t(x), _t(w), torch.ones(4), _t(bias),
                               act=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    r = rng.randn(2, 16, 16, 4).astype(np.float32)
    r_p = pack(jnp.asarray(r), p)
    want, (dx_j, dw_j) = jax.value_and_grad(
        lambda x, w: jnp.sum(pallas_conv_ad(x, w, p, True) * r_p), (0, 1))(
        pack(jnp.asarray(x), p), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    loss = (conv_ops.conv_ad(tx, tw) * _t(r)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(unpack(dx_j, p)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_j), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("ci,co,k", [(32, 64, 3), (32, 64, 1), (64, 64, 3),
                                     (128, 64, 1)])
def test_new_train_shapes_match_pallas(ci, co, k):
    """The inplanes-32 train zone's new shapes: K5 forward and sums, and
    through its VJP K1 at the transposed shape (dx) and K6 (dW), plain
    versions ≡ train_conv_stats in interpret mode at the lane pack."""
    rng = np.random.RandomState(ci + co + k)
    p = 128 // ci
    x = rng.randn(2, 16, 16, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    r = rng.randn(2, 16, 16, co).astype(np.float32)
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


def test_four_class_precropped_cli_matches_jax(tmp_path):
    """infer_precropped on a 4-class reference .tar writes four score
    images an event, each equal to the JAX CLI's."""
    data = make_synthetic_file(str(tmp_path / "in.uevt"), n_events=2,
                               hw=(HW, HW), seed=9)
    sd = random_state_dict(seed=2, num_classes=4)
    for key in ("conv11.weight", "conv11.bias"):  # tame the softmax
        sd[key] = sd[key] * 3e-4
    ckpt = save_reference_checkpoint(sd, str(tmp_path / "ref.tar"))
    common = ["-i", data, "-c", ckpt, "-b", "2", "--f32"]
    out_jax, out_port = str(tmp_path / "jax.uevt"), str(tmp_path / "p.uevt")
    assert jax_cli(common + ["-o", out_jax]) == 0
    assert port_cli(common + ["-o", out_port, "--device", "cpu"]) == 0
    a, b = EventFileReader(out_jax), EventFileReader(out_port)
    assert len(a) == len(b) == 2
    for i in range(2):
        ia, ib = (r.read_entry(i)["uburn_plane2"] for r in (a, b))
        assert len(ia) == len(ib) == 4
        sa = np.stack([im.pixels.astype(np.float32) for im in ia], -1)
        sb = np.stack([im.pixels.astype(np.float32) for im in ib], -1)
        np.testing.assert_allclose(sb.sum(-1), 1.0, atol=1e-4)
        np.testing.assert_allclose(sb, sa, atol=1e-4)
