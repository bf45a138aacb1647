"""The int8 per-conv path of the port (models/blocks.py: a BasicBlock
off its kernel and Deconv2x's integer route) beside the fused int8 layers,
against the JAX package's int8 UResNet at 8-channel streams: a UResNet
at inplanes 8 and at 4, depth 5,
32x32 synthetic events, seeded reference-init weights both packages
load, float32 compute on the CPU, the same calibrated scales (the
port's ``calibrate``, which tests/test_torch_int8_model.py holds to
JAX's within 2e-6, handed to JAX as its 'quant' collection).

At these widths JAX runs its int8 zone per conv where its fused-kernel
gates fail and its fused int8 kernels where they pass (in interpret
mode here), on its lane geometry, not on the port's compiled shapes;
the port's blocks decide by the same gates: where JAX fuses, the
kernel's wrapper (its plain version on the CPU; on the card the kernel,
its 8-channel instance at these widths, tests/test_torch_cuda.py), else
per conv, each conv's epilogue in JAX's form. Both are exact integer
sums with float32 epilogues, so the port
must agree with JAX at test_torch_int8_model.py's tolerance: every
log-probability within 1e-4·max, argmax >= 0.999. Both widths run both
routes (the test checks which).
Also: a deconv to a target that is not 2x takes the integer route
(JAX's packed_deconv2x), equal to the float deconv's crop on integer
inputs; the per-conv block reads JAX's per-ConvBN scale names, the
bypass's among them; the flagship width keeps K2-s8 and K3-s8."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import import_uresnet_state_dict
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.synthetic import synth_event
from ubresnet_tpu_torch.deploy.weights import (
    quant_scales_from_jax,
    random_state_dict,
)
from ubresnet_tpu_torch.ops.quant import calibrate
from ubresnet_tpu_torch.models import UResNet
from ubresnet_tpu_torch.models.blocks import BasicBlock, Deconv2x, deconv_to
from ubresnet_tpu_torch.ops import block as block_ops
from ubresnet_tpu_torch.ops import quant as quant_ops

torch.set_num_threads(1)

HW = 32
INT8_F32 = dataclasses.replace(Policy.f32(), fused_eval=True, quant_eval=True)
JAX_F32 = JaxPolicy(pack_width=8, compute_dtype=jnp.float32)


def _batches():
    rng = np.random.RandomState(7)
    return [np.stack([synth_event(rng, (HW, HW))["wire"]
                      for _ in range(2)])[..., None].astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("inplanes", [8, 4])
def test_per_conv_int8_matches_jax(inplanes, monkeypatch):
    sd = random_state_dict(seed=2, inplanes=inplanes)
    variables = import_uresnet_state_dict(
        {k: v.numpy() for k, v in sd.items()})
    batches = _batches()
    m = UResNet(sd, policy=INT8_F32, device="cpu")
    scales = calibrate(m, batches)
    quant = {}
    for name, v in scales.items():  # quant_scales_from_jax's inverse
        node = quant
        for part in name.split("."):
            node = node.setdefault(part, {})
        node["act_scale"] = jnp.float32(float(v))
    assert quant_scales_from_jax(quant) == scales
    q = dict(variables, quant=quant)
    model = jax_get_model("uresnet", policy=JAX_F32, input_channels=1,
                          inplanes=inplanes)
    jq = model.clone(policy=dataclasses.replace(
        JAX_F32, quant_eval=True, fused_eval=True))
    x = batches[0]
    want = np.asarray(jax.jit(lambda v, x: jq.apply(v, x, train=False))(
        q, jnp.asarray(x)))

    blocks = [m.enc[0].res1, m.enc[0].res2]
    for dec in m.dec[-2:]:
        blocks += [dec.res.res1, dec.res.res2]
    assert all(b.quant for b in blocks)
    per_conv = [b.qname for b in blocks if not b.kernel]
    routes = {}
    fused_form = BasicBlock._fused_form

    def record(block, x, dual):
        fused = fused_form(block, x, dual)
        if block.quant:  # the int8 zone's blocks
            routes[block.qname] = fused
        return fused

    monkeypatch.setattr(BasicBlock, "_fused_form", record)
    # where JAX fuses, the kernel's wrapper runs (never its plain
    # version directly): count the block wrapper's calls
    calls = []
    wrapper = block_ops.basic_block_s8

    def counted(*a, **kw):
        calls.append(1)
        return wrapper(*a, **kw)

    monkeypatch.setattr(block_ops, "basic_block_s8", counted)
    # at 8 JAX fuses every block (enc1.res2 and dec2's at the flagship
    # dec1's (16, 0, 16) and (16, 16, 16), the other three at 8
    # channels) and both upsamples; at 4 it fuses enc1.res2 and dec2's
    # blocks (8 channels fill 128 lanes at pack 16) and both upsamples
    # and runs the rest per conv. ``kernel`` says so at the zone's
    # widths, and every block takes JAX's route.
    expect_fused = ([b.qname for b in blocks] if inplanes == 8 else
                    ["enc1.res2", "dec2.res.res1", "dec2.res.res2"])
    assert per_conv == [b.qname for b in blocks
                        if b.qname not in expect_fused]
    assert [d.kernel for d in (m.dec[-2].deconv, m.dec[-1].deconv)] == [
        True, True]
    m.set_quant_scales(scales)
    # each ConvBN of a per-conv block reads its own JAX name
    assert m.enc[0].res1.cb["1"].qname == "enc1.res1.cb1"
    assert "enc1.res1.bypass" in scales and "enc1.res1.cb2" in scales
    with torch.inference_mode():
        got = m(torch.from_numpy(x)).numpy()
    print(f"inplanes {inplanes}: off K2-s8 {per_conv}; JAX's fused form "
          f"{routes}")
    assert sorted(routes) == sorted(b.qname for b in blocks)
    assert [k for k, v in routes.items() if v] == expect_fused
    assert len(calls) == len(expect_fused)
    assert got.shape == want.shape == (2, HW, HW, 3)
    d = np.abs(got - want)
    within = float((d <= 1e-4 * np.abs(want).max()).mean())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"inplanes {inplanes}: log-probs within 1e-4·max {within}; "
          f"argmax {agree}; max |Δ| {d.max()} of max {np.abs(want).max()}")
    assert within == 1.0 and agree >= 0.999


def test_int8_deconv_to_any_target():
    """An int8 deconv whose target is not 2x (the reference's odd skip
    sizes) takes the exact integer route, though JAX fuses it at an
    exact 2x (``kernel``): its accumulator times sx·sw equals the float
    deconv_to of the same integers, cropped the same way; the flagship
    width's deconvs keep K3-s8 at an exact 2x."""
    sd = random_state_dict(seed=0, inplanes=4)
    dc = Deconv2x(sd, "dec_layer2.deconv", policy=INT8_F32, device="cpu",
                  quant=True)
    assert dc.quant and dc.kernel
    dc.set_scales({"dec2.deconv": torch.tensor(0.05)})
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.uniform(0, 6, (1, 5, 7, 16)).astype(np.float32))
    for target in [(10, 14), (9, 13), (11, 15), (8, 12)]:
        got = dc(x, target)
        xq = quant_ops.quantize_act(x, dc.sx)
        ref = deconv_to(xq.double(), dc.wq.permute(2, 3, 0, 1).double(),
                        target)
        assert got.shape == (1, *target, 8)
        np.testing.assert_allclose(got.numpy(), (ref * dc.g.double()).float()
                                   .numpy(), rtol=1e-6, atol=1e-6)
    flag = random_state_dict(seed=0)
    assert Deconv2x(flag, "dec_layer2.deconv", policy=Policy.int8(),
                    device="cpu", quant=True).kernel
