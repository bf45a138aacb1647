"""The port's kernel routes against the JAX package's Pallas calls, on
the CPU: for UResNets at inplanes 16, 32, 8 and 4 with 3 classes and at
16 with 4 classes, and for ASPP-ResNet at inplanes 16 and 32, in eval
bf16, eval int8 (calibrated), one fused-train gradient, the same with
the deconv-AD upsamples (``fused_train_deconv``) and one QAT gradient
(``quant_train``), every kernel call of a forward (and backward) with
its kernel and shape.

JAX side: the model traced with ``jax.make_jaxpr`` under its fused
policy (``pack_width`` 8 with ``fused_eval``, ``quant_eval``,
``fused_train``, ``fused_train`` and ``fused_train_deconv``, or
``fused_train`` and ``quant_train``), its Pallas entry points wrapped
with ``monkeypatch`` so each call is counted by name and shape (the
blocks import them at call time; pallas_conv_dw's recursion onto a
lane-padded cotangent counts once; pallas_deconv2x_ad counts beside the
three legs it calls). Port side: the same model on the CPU, its kernel
wrappers (whose plain versions run there) counted the same way — every
wrapper call is a launch on the card (models/blocks.py routes); K10
(deconv2x_bwd), the deconv's backward in one launch, counts as the
fused_conv_s2k4 and pallas_deconv_dw calls of _deconv_ad_bwd that it
stands for, at its (ci, co).

In every mode and at every width the two lists are equal, and every
shape the port calls a wrapper with is compiled (ops/_build.py:SHAPES),
so none raises on the card.

Spatial size: 32x32, the smallest whose routes equal 512x512's (the
lane re-views need the enc1 and dec1 widths to divide by the lane
pack, 16 at 8-channel streams, and depth 5 halves 32 down to 1; ASPP's
zone needs widths that are a multiple of 32); the inplanes-32 eval
trace is checked at 512x512 too. Batch 1."""
import collections
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ubresnet_tpu.ops.pallas_conv as jpc
import ubresnet_tpu.ops.pallas_train as jpt
from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import (
    import_aspp_state_dict,
    import_uresnet_state_dict,
)
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import random_state_dict
from ubresnet_tpu_torch.models import (
    ASPPResNet,
    TrainASPPResNet,
    TrainUResNet,
    UResNet,
)
from ubresnet_tpu_torch.ops import block as block_ops
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import deconv as deconv_ops
from ubresnet_tpu_torch.ops import pool as pool_ops
from ubresnet_tpu_torch.ops import train_conv as train_ops
from ubresnet_tpu_torch.ops._build import SHAPES
from ubresnet_tpu_torch.ops.quant import calibrate

torch.set_num_threads(1)

HW = 32
UR = "uresnet"
AS = "aspp_resnet"
# (arch, inplanes, classes)
CONFIGS = [(UR, 16, 3), (UR, 32, 3), (UR, 16, 4), (UR, 8, 3), (UR, 4, 3),
           (AS, 16, 3), (AS, 32, 3)]
IDS = ["16", "32", "16-4cls", "8", "4", "aspp16", "aspp32"]
MODES = ["eval", "int8", "train", "train_deconv", "qat"]
JAX_POLICY = {
    "eval": JaxPolicy(pack_width=8, fused_eval=True),
    "int8": JaxPolicy(pack_width=8, fused_eval=True, quant_eval=True),
    "train": JaxPolicy(pack_width=8, fused_train=True),
    "train_deconv": JaxPolicy(pack_width=8, fused_train=True,
                              fused_train_deconv=True),
    "qat": JaxPolicy(pack_width=8, fused_train=True, quant_train=True),
}
# the port's policy of each train mode (fused_train is its default)
PORT_TRAIN_POLICY = {
    "train": Policy(),
    "train_deconv": Policy(fused_train_deconv=True),
    "qat": Policy(quant_train=True),
}
S8 = "_s8"


def _chan(x, p):
    return x.shape[-1] // p


# JAX entry point -> (module, kernel of the port, shape from the call)
def _jax_keys():
    def conv(x, w, *a, **k):
        s8 = S8 if x.dtype == jnp.int8 else ""
        return "conv_bn_act" + s8, (w.shape[2], w.shape[3], w.shape[0])

    def block(x, w1, *a, **k):
        s8 = S8 if x.dtype == jnp.int8 else ""
        proj = len(a) >= 6 and a[5] is not None or k.get("wb") is not None
        return "basic_block" + s8, (w1.shape[2], 0, w1.shape[3], bool(proj))

    def dual(a_, b_, w1, *a, **k):
        s8 = S8 if a_.dtype == jnp.int8 else ""
        c = w1.shape[2] // 2
        return "basic_block" + s8, (c, c, w1.shape[3], True)

    def deconv(x, w, *a, **k):
        s8 = S8 if x.dtype == jnp.int8 else ""
        return "deconv2x" + s8, (w.shape[2], w.shape[3])

    def pool(x, *, p, **k):
        return "maxpool3x3s2", (_chan(x, p),)

    def stats(x, w, *a, **k):
        return "conv_stats", (w.shape[2], w.shape[3], w.shape[0])

    def dw(x, dy, *, p, kw, **k):
        return "conv_dw", (_chan(x, p), _chan(dy, p), kw)

    def s2k4(y, w, **k):  # w is the deconv's kernel, (co, ci) transposed
        return "conv_s2k4", (w.shape[3], w.shape[2])

    def deconv_dw(x, dy, *, p, **k):
        return "deconv_dw", (_chan(x, p), _chan(dy, 2 * p))

    def deconv_ad(x, w, *a, **k):
        return "deconv2x_ad", (w.shape[2], w.shape[3])

    return {
        "fused_packed_conv": conv, "fused_basic_block": block,
        "fused_dual_block": dual, "fused_packed_deconv2x": deconv,
        "fused_pool3x3s2": pool, "train_conv_stats": stats,
        "pallas_conv_dw": dw, "fused_conv_s2k4": s2k4,
        "pallas_deconv_dw": deconv_dw, "pallas_deconv2x_ad": deconv_ad,
    }


@contextlib.contextmanager
def _count_jax(calls):
    active = collections.Counter()
    with pytest.MonkeyPatch.context() as mp:
        for name, key in _jax_keys().items():
            for mod in (jpc, jpt):
                fn = getattr(mod, name, None)
                if fn is None:
                    continue

                def counted(*a, _fn=fn, _name=name, _key=key, **kw):
                    if not active[_name]:  # the outermost call only
                        calls[_key(*a, **kw)] += 1
                    active[_name] += 1
                    try:
                        return _fn(*a, **kw)
                    finally:
                        active[_name] -= 1

                mp.setattr(mod, name, counted)
        yield


def _input(hw):
    return np.random.RandomState(0).uniform(0, 3, (1, hw, hw, 1)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _weights(arch, inplanes, classes):
    """Seeded reference weights, the JAX variables imported from them,
    and the int8 scales the port calibrates on them (JAX's 'quant'
    names), 32x32."""
    sd = random_state_dict(seed=1, inplanes=inplanes, num_classes=classes,
                           arch=arch)
    imported = import_uresnet_state_dict if arch == UR else \
        import_aspp_state_dict
    variables = imported({k: v.numpy() for k, v in sd.items()})
    model = (UResNet if arch == UR else ASPPResNet)(
        sd, policy=Policy.int8(), device="cpu")
    return sd, variables, calibrate(model, [_input(HW)])


def _quant_tree(scales):
    """The 'quant' collection holding ``scales`` (quant_scales_from_jax's
    inverse)."""
    tree = {}
    for name, v in scales.items():
        node = tree
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["act_scale"] = jnp.float32(float(v))
    return tree


@functools.lru_cache(maxsize=None)
def _jax_routes(arch, inplanes, classes, mode, hw):
    pol = JAX_POLICY[mode]
    kw = {} if arch == UR else {"aspp_branch_features": 16}
    model = jax_get_model(arch, policy=pol, input_channels=1,
                          inplanes=inplanes, num_classes=classes, **kw)
    x = jax.ShapeDtypeStruct((1, hw, hw, 1), jnp.float32)
    _, variables, scales = _weights(arch, inplanes, classes)
    calls = collections.Counter()
    if mode in PORT_TRAIN_POLICY:
        def loss(params, stats, x):
            y, _ = model.apply({"params": params, "batch_stats": stats},
                               x, train=True, logits=True,
                               mutable=["batch_stats"])
            return jnp.sum(y.astype(jnp.float32) ** 2)

        fn = jax.grad(loss)
        args = (variables["params"], variables["batch_stats"], x)
    else:
        if mode == "int8":
            variables = dict(variables, quant=_quant_tree(scales))
        fn = lambda v, x: model.apply(v, x, train=False)  # noqa: E731
        args = (variables, x)
    with _count_jax(calls):
        jax.make_jaxpr(fn)(*args)
    return calls


def jax_routes(arch, inplanes, classes, mode, hw=HW):
    return collections.Counter(_jax_routes(arch, inplanes, classes, mode,
                                           hw))


# the port's wrappers -> shape from the call
def _port_keys():
    def conv(x, w, *a, **k):
        return (w.shape[2], w.shape[3], w.shape[0])

    def block(a, b, w1, *args, **k):
        wb = args[5] if len(args) > 5 else k.get("wb", k.get("wbq"))
        return (a.shape[-1], 0 if b is None else b.shape[-1], w1.shape[3],
                wb is not None)

    def deconv(x, w, *a, **k):
        return (w.shape[2], w.shape[3])

    return [
        (conv_ops, "conv_bn_act", conv), (conv_ops, "conv_bn_act_s8", conv),
        (block_ops, "basic_block", block),
        (block_ops, "basic_block_s8", block),
        (deconv_ops, "deconv2x", deconv), (deconv_ops, "deconv2x_s8", deconv),
        (pool_ops, "maxpool3x3s2", lambda x: (x.shape[-1],)),
        (train_ops, "conv_stats", conv),
        (conv_ops, "conv_dw", lambda x, dy, k: (x.shape[-1], dy.shape[-1], k)),
        (deconv_ops, "conv_s2k4", deconv),
        (deconv_ops, "deconv_dw",
         lambda x, dy: (x.shape[-1], dy.shape[-1])),
        (deconv_ops, "deconv2x_bwd", lambda x, dy, w: (w.shape[2], w.shape[3])),
        (deconv_ops, "deconv2x_ad", deconv),
    ]


# A port wrapper whose one launch runs several of JAX's Pallas calls, and
# the calls it stands for: K10 is _deconv_ad_bwd's fused_conv_s2k4 and
# pallas_deconv_dw at its (ci, co)
STANDS_FOR = {"deconv2x_bwd": ("conv_s2k4", "deconv_dw")}


def port_routes(arch, inplanes, classes, mode, monkeypatch, hw=HW):
    sd, _, scales = _weights(arch, inplanes, classes)
    x = torch.from_numpy(_input(hw))
    calls = collections.Counter()
    with monkeypatch.context() as mp:
        for mod, name, key in _port_keys():
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, _key=key, **kw):
                for as_name in STANDS_FOR.get(_name, (_name,)):
                    calls[as_name, _key(*a, **kw)] += 1
                return _fn(*a, **kw)

            mp.setattr(mod, name, counted)
        if mode in PORT_TRAIN_POLICY:
            model = (TrainUResNet if arch == UR else TrainASPPResNet)(
                sd, policy=PORT_TRAIN_POLICY[mode], device="cpu").train()
            y = model(x, logits=True)
            (y.float() ** 2).sum().backward()
        else:
            pol = Policy.int8() if mode == "int8" else Policy()
            model = (UResNet if arch == UR else ASPPResNet)(
                sd, policy=pol, device="cpu")
            if mode == "int8":
                model.set_quant_scales(scales)
            with torch.inference_mode():
                model(x)
    return calls


def _uncompiled(calls):
    """The calls at a (kernel, shape) no instance was compiled for (K4
    takes any C % 8 == 0; deconv2x_ad is K3's with K10's, and the dx and
    dW legs are K10's launches)."""
    kernel = {"deconv2x_ad": "deconv2x", "conv_s2k4": "deconv2x_bwd",
              "deconv_dw": "deconv2x_bwd"}
    return sorted((k, s) for k, s in calls if k != "maxpool3x3s2"
                  and s not in SHAPES[kernel.get(k, k)])


# the upsamples on K3 + K10 under fused_train_deconv (JAX's
# pallas_deconv2x_ad), per inplanes of the UResNet: dec2 and dec1 where
# their lanes fit, never dec3 or deeper (outside the packed zone)
DECONV_AD = {16: {(64, 32), (32, 16)}, 32: {(64, 32)},
             8: {(32, 16), (16, 8)}, 4: {(16, 8), (8, 4)}}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch,inplanes,classes", CONFIGS, ids=IDS)
def test_routes_equal_jax(arch, inplanes, classes, mode, monkeypatch):
    """The port's wrapper calls equal JAX's Pallas calls, kernel, shape
    and count, and every one is compiled (none raises on the card)."""
    want = jax_routes(arch, inplanes, classes, mode)
    got = port_routes(arch, inplanes, classes, mode, monkeypatch)
    print(f"{arch} inplanes {inplanes}, {classes} classes, {mode}: "
          f"{sorted(want.items())}")
    assert got == want
    assert not _uncompiled(got)
    if mode == "eval" and arch == UR:  # no stem pool at 8-channel streams
        assert sum(want.values()) == {16: 11, 32: 9, 8: 10, 4: 9}[inplanes]
    if mode == "train_deconv" and arch == UR:
        assert {s for k, s in got if k == "deconv2x_ad"} == \
            DECONV_AD[inplanes]


@pytest.mark.parametrize("mode", ["eval", "int8", "train"])
@pytest.mark.parametrize("inplanes", [8, 4])
def test_item_8b_is_the_jax_difference(inplanes, mode, monkeypatch):
    """At 8-channel streams (inplanes 8 and 4) the port runs every JAX
    Pallas call on its kernel, the 8-channel ones among them: in eval,
    int8 and train the lists are equal and at least one call per mode
    has an 8- or 4-channel side, which the flagship never calls."""
    want = jax_routes(UR, inplanes, 3, mode)
    got = port_routes(UR, inplanes, 3, mode, monkeypatch)
    eight = {(k, s) for k, s in got if min(s[:3] if k.startswith(
        "basic_block") else s[:2]) in (4, 8)}
    print(f"inplanes {inplanes} {mode}: 8-channel calls {sorted(eight)}")
    assert got == want and eight
    assert not _uncompiled(got)


@pytest.mark.parametrize("inplanes", [8, 4])
def test_int8_at_8_channel_streams(inplanes, monkeypatch):
    """int8 keeps no cuDNN exception: every JAX int8 call at 8 and 4 is
    a wrapper call of the port, at a compiled shape."""
    got = port_routes(UR, inplanes, 3, "int8", monkeypatch)
    assert got == jax_routes(UR, inplanes, 3, "int8")
    assert not _uncompiled(got)


def test_routes_at_512_equal_32():
    """The traced size stands for 512x512: JAX's eval routes of the
    inplanes-32 model there are the same."""
    assert (jax_routes(UR, 32, 3, "eval", hw=512)
            == jax_routes(UR, 32, 3, "eval"))
