"""The port's ASPP-ResNet (ubresnet_tpu_torch/models/aspp_resnet.py)
against the JAX package's ASPPResNet on the CPU: eval forward, the
weights' crossing, the kernel zone's routing and the dilation gate.

Weights come from JAX's ``model.init`` with seeded random BN statistics,
BN affines and conv biases laid over it (init leaves them trivial, and
the BN fold is what the port's eval layers rebuild), and cross over
through ``state_dict_from_jax``. Bound for the f32 eval forward:
|Δ| ≤ 1e-5·max|logit| and identical argmax — tests/test_torch_model.py's
bound between two f32 paths of the whole model.

The dilation gate: JAX's branch width is 16 whatever the inplanes, so
at inplanes 4 enc3 has 32 channels and the d3 and d5 branches have the
shape (32, 16, 3), which K1's and K5's tables hold (the train zone's
dec1 conv and its transpose). A gate on (ci, co, k) alone would run them
undilated, through the plain versions here. The inplanes-4 forward runs
with the kernel zone on (Policy.f32 with fused_eval) so that such a
fault changes the numbers."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.exporters import export_aspp_state_dict
from ubresnet_tpu.deploy.importers import import_aspp_state_dict
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu_torch import ops
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import (
    load_reference_checkpoint,
    random_state_dict,
    save_reference_checkpoint,
    state_dict_from_jax,
)
from ubresnet_tpu_torch.models import (
    ASPPResNet,
    TrainASPPResNet,
    arch_of,
    blocks,
    get_model,
)
from ubresnet_tpu_torch.models.aspp_resnet import config_from_state_dict
from ubresnet_tpu_torch.ops import block as block_ops
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import deconv as deconv_ops
from ubresnet_tpu_torch.ops import pool as pool_ops
from ubresnet_tpu_torch.ops import train_conv as train_ops

torch.set_num_threads(1)

F32 = Policy.f32()
F32_FUSED = dataclasses.replace(Policy.f32(), fused_eval=True)
F32_ZONE = dataclasses.replace(Policy.f32(), fused_train=True)


def jax_aspp(inplanes, policy=None):
    return jax_get_model("aspp_resnet", policy=policy or JaxPolicy.f32(),
                         input_channels=1, inplanes=inplanes,
                         aspp_branch_features=16)


@functools.lru_cache(maxsize=None)
def _init_tree(inplanes, seed=0):
    """``model.init``'s tree at this width (one init compile per width
    and seed in the module)."""
    return jax.jit(jax_aspp(inplanes).init)(jax.random.PRNGKey(seed),
                                            jnp.zeros((1, 64, 64, 1)))


def jax_variables(inplanes, seed=0):
    """``model.init``'s tree with seeded BN statistics, BN affines and
    conv biases."""
    v = _init_tree(inplanes, seed)
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name = jax.tree_util.keystr(path)
        shape = np.shape(a)
        if name.endswith("['var']"):
            return (rng.rand(*shape) * 0.5 + 0.75).astype(np.float32)
        if name.endswith("['mean']"):
            return (0.05 * rng.randn(*shape)).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name.endswith("['bias']"):
            return (0.05 * rng.randn(*shape)).astype(np.float32)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, {"params": v["params"], "batch_stats": v["batch_stats"]})


@pytest.fixture(scope="module", params=[16, 4, 32],
                ids=["p16", "p4", "p32"])
def case(request):
    return request.param, jax_variables(request.param)


def _input(seed, h, w, b=2):
    """Sparse ADC-like images: a few hundred hits on a zero plane."""
    rng = np.random.RandomState(seed)
    x = np.zeros((b, h, w, 1), np.float32)
    for i in range(b):
        n = h * w // 16
        x[i, rng.randint(0, h, n), rng.randint(0, w, n), 0] = \
            rng.rand(n) * 50 + 5
    return x


def _close(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    assert float((got.argmax(-1) == want.argmax(-1)).mean()) == 1.0


_WANT = {}


@pytest.mark.parametrize("policy", [F32, F32_FUSED], ids=["f32", "f32-zone"])
@pytest.mark.parametrize("hw", [(64, 64), (64, 96)], ids=["64x64", "64x96"])
def test_aspp_matches_jax(case, policy, hw):
    """Eval logits ≡ JAX ASPPResNet under Policy.f32(), unfused and with
    the kernel zone's plain versions, at the flagship width, at
    inplanes 4 (the dilation gate) and at the reference trainer's
    inplanes 32."""
    p, variables = case
    x = _input(1, *hw)
    if (p, hw) not in _WANT:  # JAX's logits, the same for both policies
        _WANT[p, hw] = np.asarray(jax.jit(lambda v, x: jax_aspp(p).apply(
            v, x, train=False, logits=True))(variables, jnp.asarray(x)))
    want = _WANT[p, hw]
    model = ASPPResNet(state_dict_from_jax(variables), policy=policy,
                       device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x), logits=True).numpy()
    assert got.shape == want.shape == (2, *hw, 3)
    _close(got, want)


def test_state_dict_from_jax_equals_jax_exporter(case):
    """The ASPP half of state_dict_from_jax ≡ JAX's export_aspp_state_dict,
    key for key and bit for bit (JAX's num_batches_tracked counters
    aside, which the port never reads)."""
    _, variables = case
    got = state_dict_from_jax(variables)
    want = {k: v for k, v in export_aspp_state_dict(variables).items()
            if not k.endswith("num_batches_tracked")}
    assert list(got) == list(want)
    assert sum(k.startswith("ASPP_") for k in got) == 3 * 5 * 6
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("p", [16, 4])
def test_random_weights_import_into_jax_init_tree(p):
    """The seeded ASPP weights carry the reference layout: JAX's
    import_aspp_state_dict gives model.init's tree, path for path and
    shape for shape, and the import runs; the port reads the geometry
    off them and registers the architecture."""
    sd = random_state_dict(seed=1, inplanes=p, arch="aspp_resnet")
    variables = import_aspp_state_dict({k: v.numpy() for k, v in sd.items()})
    model = jax_aspp(p)
    init = _init_tree(p)

    def paths(tree):
        return {jax.tree_util.keystr(k): tuple(np.shape(x)) for k, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    assert paths(variables["params"]) == paths(init["params"])
    assert paths(variables["batch_stats"]) == paths(init["batch_stats"])
    out = jax.jit(functools.partial(model.apply, train=False))(
        variables, jnp.zeros((1, 64, 64, 1)))
    assert out.shape == (1, 64, 64, 3)
    cfg = config_from_state_dict(sd)
    assert (cfg.inplanes, cfg.aspp_branch_features, cfg.num_classes,
            cfg.input_channels, cfg.final_conv_kernels) == (p, 16, 3, 1, 16)
    assert arch_of(sd) == "aspp_resnet"
    assert arch_of(random_state_dict(seed=1)) == "uresnet"
    # the trainable model's state_dict is a reference ASPP state_dict
    train = TrainASPPResNet(sd, policy=F32, device="cpu")
    assert set(train.state_dict()) == set(sd)
    with pytest.raises(ValueError, match="depth 5"):
        random_state_dict(seed=1, arch="aspp_resnet", depth=4)


def test_tar_round_trip_names_the_arch(tmp_path):
    sd = random_state_dict(seed=0, arch="aspp_resnet")
    path = str(tmp_path / "aspp.tar")
    save_reference_checkpoint({f"module.{k}": v for k, v in sd.items()},
                              path)
    loaded, info = load_reference_checkpoint(path)
    assert info == {"inplanes": 16, "input_channels": 1, "num_classes": 3,
                    "arch": "aspp_resnet"}
    assert set(loaded) == set(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


def _counting(monkeypatch):
    """Count the calls of each kernel wrapper the eval model makes (on
    the CPU a wrapper runs its plain version and counts no launch)."""
    calls = {}
    for mod, name in ((conv_ops, "conv_bn_act"), (block_ops, "basic_block"),
                      (deconv_ops, "deconv2x"),
                      (pool_ops, "maxpool3x3s2")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def test_bf16_zone_at_the_flagship_width(monkeypatch):
    """The default (bf16, kernel zone) policy at inplanes 16 routes
    exactly UResNet's 11 zone layers per forward — K1 x2, K2 x6, K3 x2,
    K4 x1 — through the wrappers (their plain versions here); ASPP's
    branches, the recompressions and the deep stages stay F.conv2d;
    probabilities finite and normalized, argmax close to f32."""
    sd = random_state_dict(seed=2, arch="aspp_resnet")
    x = torch.from_numpy(_input(3, 64, 96))
    model = get_model("aspp_resnet", sd, device="cpu")
    assert not any(m.kernel for a in model.aspp for m in a.branches)
    assert not any(c.kernel for c in model.combine)
    calls = _counting(monkeypatch)
    ops.reset_launch_counts()
    with torch.inference_mode():
        lp = model(x)
    assert calls == {"conv_bn_act": 2, "basic_block": 6, "deconv2x": 2,
                     "maxpool3x3s2": 1}
    assert set(ops.launch_counts().values()) == {0}
    assert lp.dtype == torch.float32 and torch.isfinite(lp).all()
    torch.testing.assert_close(lp.exp().sum(-1), torch.ones(2, 64, 96))
    with torch.inference_mode():
        ref = get_model("aspp_resnet", sd, policy=F32, device="cpu")(x)
    assert float((lp.argmax(-1) == ref.argmax(-1)).float().mean()) > 0.9


@pytest.mark.parametrize("p", [16, 4])
def test_no_dilated_conv_reaches_k1_or_k5(p):
    """Every dilated branch is off the kernels in eval (K1) and train
    (K5); at inplanes 4 their (ci, co, k) is in both tables, and the
    undilated 3x3 branch of the same shape is off them too: ASPP is
    outside the JAX package's packed zone, where JAX runs every conv as
    XLA (models/blocks.py routes)."""
    sd = random_state_dict(seed=0, inplanes=p, arch="aspp_resnet")
    ev = ASPPResNet(sd, policy=F32_FUSED, device="cpu")
    tr = TrainASPPResNet(sd, policy=F32_ZONE, device="cpu")
    convs = [m for m in ev.modules() if isinstance(m, blocks.ConvBN)]
    train_convs = [m for m in tr.modules() if isinstance(m, blocks.Conv)]
    dilated = [m for m in convs if m.dilation != 1]
    train_dilated = [m for m in train_convs if m.dilation != 1]
    assert len(dilated) == len(train_dilated) == 6
    assert not any(m.kernel for m in dilated)
    assert not any(m.zone for m in train_dilated)
    assert [m.pad for m in dilated] == [3, 5] * 3
    if p == 4:
        shape = tuple(sd["ASPP_layer_enc3.B3_conv.weight"].shape)
        assert shape == (16, 32, 3, 3)
        assert conv_ops.supports(32, 16, 3) and train_ops.supports(32, 16, 3)
        # B2: (32, 16, 3), dilation 1, outside the zone
        assert not ev.aspp[0].branches[1].kernel
        assert not tr.ASPP_layer_enc3.B2_conv.zone


def test_aspp_zone_count_in_train_mode():
    """The train zone at the flagship width is UResNet's: 17 zone convs
    (16 BN-fed plus the classifier), no ASPP conv among them."""
    sd = random_state_dict(seed=0, arch="aspp_resnet")
    tr = TrainASPPResNet(sd, policy=F32_ZONE, device="cpu")
    zone = [n for n, m in tr.named_modules() if getattr(m, "zone", False)]
    assert len(zone) == 17
    assert not any(n.startswith("ASPP_") for n in zone)
