"""The port's kernel routes against the JAX package's Pallas calls, on
the CPU: for UResNets at inplanes 16, 32, 8 and 4 with 3 classes and at
16 with 4 classes, in eval bf16, eval int8 (calibrated) and one
fused-train gradient, every kernel call of a forward (and backward)
with its kernel and shape.

JAX side: the model traced with ``jax.make_jaxpr`` under its fused
policy (``pack_width`` 8 with ``fused_eval``, ``quant_eval`` or
``fused_train``), its Pallas entry points wrapped with ``monkeypatch``
so each call is counted by name and shape (the blocks import them at
call time; pallas_conv_dw's recursion onto a lane-padded cotangent
counts once). Port side: the same model on the CPU, its kernel wrappers
(whose plain versions run there) counted the same way — every wrapper
call is a launch on the card (models/blocks.py routes).

At 16 and 32 the two lists are equal in every mode. At 8 and 4 the
port leaves exactly the JAX calls whose (kernel, shape) is in
models/blocks.py:ITEM_8B to cuDNN, and the constant is exactly those.

Spatial size: 32x32, the smallest whose routes equal 512x512's (the
lane re-views need the enc1 and dec1 widths to divide by the lane
pack, 16 at 8-channel streams, and depth 5 halves 32 down to 1); the
inplanes-32 eval trace is checked at 512x512 too. Batch 1."""
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
from ubresnet_tpu.deploy.importers import import_uresnet_state_dict
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import random_state_dict
from ubresnet_tpu_torch.models import TrainUResNet, UResNet
from ubresnet_tpu_torch.models.blocks import ITEM_8B
from ubresnet_tpu_torch.ops import block as block_ops
from ubresnet_tpu_torch.ops import conv as conv_ops
from ubresnet_tpu_torch.ops import deconv as deconv_ops
from ubresnet_tpu_torch.ops import pool as pool_ops
from ubresnet_tpu_torch.ops import train_conv as train_ops
from ubresnet_tpu_torch.ops._build import SHAPES
from ubresnet_tpu_torch.ops.quant import calibrate

torch.set_num_threads(1)

HW = 32
CONFIGS = [(16, 3), (32, 3), (16, 4), (8, 3), (4, 3)]
MODES = ["eval", "int8", "train"]
JAX_POLICY = {
    "eval": JaxPolicy(pack_width=8, fused_eval=True),
    "int8": JaxPolicy(pack_width=8, fused_eval=True, quant_eval=True),
    "train": JaxPolicy(pack_width=8, fused_train=True),
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

    return {
        "fused_packed_conv": conv, "fused_basic_block": block,
        "fused_dual_block": dual, "fused_packed_deconv2x": deconv,
        "fused_pool3x3s2": pool, "train_conv_stats": stats,
        "pallas_conv_dw": dw,
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
def _weights(inplanes, classes):
    """Seeded reference weights, the JAX variables imported from them,
    and the int8 scales the port calibrates on them (JAX's 'quant'
    names), 32x32."""
    sd = random_state_dict(seed=1, inplanes=inplanes, num_classes=classes)
    variables = import_uresnet_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    model = UResNet(sd, policy=Policy.int8(), device="cpu")
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
def _jax_routes(inplanes, classes, mode, hw):
    pol = JAX_POLICY[mode]
    model = jax_get_model("uresnet", policy=pol, input_channels=1,
                          inplanes=inplanes, num_classes=classes)
    x = jax.ShapeDtypeStruct((1, hw, hw, 1), jnp.float32)
    _, variables, scales = _weights(inplanes, classes)
    calls = collections.Counter()
    if mode == "train":
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


def jax_routes(inplanes, classes, mode, monkeypatch, hw=HW):
    return collections.Counter(_jax_routes(inplanes, classes, mode, hw))


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
    ]


def port_routes(inplanes, classes, mode, monkeypatch, hw=HW):
    sd, _, scales = _weights(inplanes, classes)
    x = torch.from_numpy(_input(hw))
    calls = collections.Counter()
    with monkeypatch.context() as mp:
        for mod, name, key in _port_keys():
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=name, _key=key, **kw):
                calls[_name, _key(*a, **kw)] += 1
                return _fn(*a, **kw)

            mp.setattr(mod, name, counted)
        if mode == "train":
            model = TrainUResNet(sd, policy=Policy(), device="cpu").train()
            y = model(x, logits=True)
            (y.float() ** 2).sum().backward()
        else:
            pol = Policy.int8() if mode == "int8" else Policy()
            model = UResNet(sd, policy=pol, device="cpu")
            if mode == "int8":
                model.set_quant_scales(scales)
            with torch.inference_mode():
                model(x)
    return calls


def _diff(jax_calls, port_calls):
    assert not port_calls - jax_calls, "the port launches where JAX does not"
    return jax_calls - port_calls


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("inplanes,classes", CONFIGS[:3],
                         ids=["16", "32", "16-4cls"])
def test_routes_equal_jax(inplanes, classes, mode, monkeypatch):
    want = jax_routes(inplanes, classes, mode, monkeypatch)
    got = port_routes(inplanes, classes, mode, monkeypatch)
    print(f"inplanes {inplanes}, {classes} classes, {mode}: "
          f"{sorted(want.items())}")
    assert got == want
    if mode == "eval":
        assert sum(want.values()) == (9 if inplanes == 32 else 11)


def _legs(item):
    """An ITEM_8B entry with the launches it stands for: a train-zone
    conv (K5) with its dx (K1, co read in groups of 4) and dW (K6)."""
    kernel, shape = item
    if kernel != "conv_stats":
        return {item}
    ci, co, k = shape
    return {item, ("conv_bn_act", (-(-co // 4) * 4, ci, k)),
            ("conv_dw", shape)}


def test_item_8b_is_the_jax_difference(monkeypatch):
    """At inplanes 8 and 4, bf16 eval and train: the port runs every JAX
    call but the ITEM_8B ones (with their train legs), ITEM_8B holds
    nothing else, and every call the port makes has a compiled kernel
    (none raises on the card)."""
    off = set()
    for inplanes in (8, 4):
        for mode in ("eval", "train"):
            got = port_routes(inplanes, 3, mode, monkeypatch)
            diff = _diff(jax_routes(inplanes, 3, mode, monkeypatch), got)
            print(f"inplanes {inplanes} {mode}: off the kernels "
                  f"{sorted(diff)}")
            off |= set(diff)
            assert all(shape in SHAPES[kernel] for kernel, shape in got)
    assert off == set().union(*map(_legs, ITEM_8B))


@pytest.mark.parametrize("inplanes", [8, 4])
def test_int8_at_8_channel_streams(inplanes, monkeypatch):
    """int8 keeps no cuDNN exception: every JAX int8 call at 8 and 4 is
    a wrapper call of the port (which raises on the card where no
    instance was compiled, tests/test_torch_cuda.py)."""
    assert (port_routes(inplanes, 3, "int8", monkeypatch)
            == jax_routes(inplanes, 3, "int8", monkeypatch))


def test_routes_at_512_equal_32(monkeypatch):
    """The traced size stands for 512x512: JAX's eval routes of the
    inplanes-32 model there are the same."""
    assert (jax_routes(32, 3, "eval", monkeypatch, hw=512)
            == jax_routes(32, 3, "eval", monkeypatch))
