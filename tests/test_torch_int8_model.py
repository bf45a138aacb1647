"""The port's int8 UResNet (Policy quant_eval, ops/quant.py) against the
JAX package's, float32 compute on the CPU, flagship width (inplanes 16,
depth 5, so JAX takes its packed-zone routes), 64x64 synthetic events,
seeded reference-init weights (deploy/weights.py:random_state_dict,
seed 2) that both packages load.

(a) Calibrated scales: port ``calibrate`` vs JAX ``calibrate``, every
    layer, abs-max and percentile 99.9.
(b) Forward with the same scales (imported through
    ``quant_scales_from_jax``) vs JAX ``UResNet`` under Policy(pack 8,
    f32, quant_eval, fused_eval), its Pallas int8 kernels in interpret
    mode: each int8 layer fed JAX's own input, and the whole model.
(c) The int8 forward vs the port's own f32 forward, at the JAX test's
    bar (tests/test_quant.py:276-303).
(d) Guards: no scales, a width JAX would not pack, depth ≠ 5.

Tolerances and why: the integer sums are exact and the f32 epilogues
are the same operations (each affine one FMA, as XLA compiles it), so
with the same scales every int8 layer and the whole model agree within
1e-4·max (measured 4e-7·max for the log-probs). What cannot agree
exactly is what runs in float32 outside the kernels: the unquantized
deep stages sum their convolutions in another order than XLA, and XLA's
rsqrt in a BN fold is not correctly rounded. The calibrated scales,
maxima over such activations, therefore differ by up to ~20 ulp: (a)
holds 2e-6 relative (measured 1.1e-6 at abs-max, 1.3e-6 on other
weights). The same ulps can move a value across a rounding boundary of
the 127-level grid — a one-step flip, which no input here shows (the
tests print any)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import import_uresnet_state_dict
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu.ops.quant import calibrate as jax_calibrate
from ubresnet_tpu_torch import ops
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.synthetic import synth_event
from ubresnet_tpu_torch.deploy.weights import (
    quant_scales_from_jax,
    random_state_dict,
)
from ubresnet_tpu_torch.models import UResNet
from ubresnet_tpu_torch.ops.pool import maxpool3x3s2
from ubresnet_tpu_torch.ops.quant import calibrate

torch.set_num_threads(1)

HW = 64
INT8_F32 = dataclasses.replace(Policy.f32(), fused_eval=True, quant_eval=True)
JAX_F32 = JaxPolicy(pack_width=8, compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def setup():
    sd = random_state_dict(seed=2)
    variables = import_uresnet_state_dict({k: v.numpy() for k, v in sd.items()})
    rng = np.random.RandomState(7)
    batches = [np.stack([synth_event(rng, (HW, HW))["wire"]
                         for _ in range(2)])[..., None].astype(np.float32)
               for _ in range(2)]
    model = jax_get_model("uresnet", policy=JAX_F32, input_channels=1,
                          inplanes=16)
    qvars = {pct: jax_calibrate(model, variables, batches, percentile=pct)
             for pct in (0.0, 99.9)}
    return sd, model, qvars, batches


def _port(sd, scales=None, policy=INT8_F32):
    m = UResNet(sd, policy=policy, device="cpu")
    if scales is not None:
        m.set_quant_scales(scales)
    return m


@pytest.mark.parametrize("pct", [0.0, 99.9], ids=["absmax", "p99.9"])
def test_calibrated_scales_match_jax(setup, pct):
    sd, _, qvars, batches = setup
    want = quant_scales_from_jax(qvars[pct]["quant"])
    got = calibrate(_port(sd), batches, percentile=pct)
    assert set(got) == set(want) and len(want) == 57  # 51 ConvBNs, 5 deconvs, stem
    worst = max(abs(float(got[k]) - float(want[k])) / float(want[k])
                for k in want)
    print(f"max relative scale difference {worst}")
    assert worst <= 2e-6, worst
    assert all(float(s) > 0 for s in got.values())


def _jax_int8(model):
    return model.clone(policy=dataclasses.replace(
        JAX_F32, quant_eval=True, fused_eval=True))


def _unpacked(a, c):
    a = np.array(a)
    return a.reshape(a.shape[0], a.shape[1], -1, c)


def test_int8_layers_match_jax_on_jax_inputs(setup):
    """Each int8 layer of the port (stem, enc1 blocks, the dec2/dec1
    deconvs and blocks, head) fed the input JAX's own int8 forward gave
    that layer: its output against JAX's."""
    sd, model, qvars, batches = setup
    q = qvars[0.0]
    x = batches[0]
    _, st = _jax_int8(model).apply(q, jnp.asarray(x), train=False,
                                   capture_intermediates=True,
                                   mutable=["intermediates"])
    inter = st["intermediates"]

    def out(path, c):
        node = inter
        for p in path.split("."):
            node = node[p]
        return _unpacked(node["__call__"][0], c)

    m = _port(sd, quant_scales_from_jax(q["quant"]))
    enc1, dec2, dec1 = m.enc[0], m.dec[-2], m.dec[-1]
    t = torch.from_numpy
    stem = out("stem", 16)
    cases = {
        "stem": (m.conv1, (t(x),), stem),
        "enc1.res1": (enc1.res1, (maxpool3x3s2(t(stem)),),
                      out("enc1.res1", 32)),
        "enc1.res2": (enc1.res2, (t(out("enc1.res1", 32)),),
                      out("enc1", 32)),
        "dec2.deconv": (dec2.deconv, (t(out("dec3", 64)),),
                        out("dec2.deconv", 32)),
        "dec2.res.res1": (dec2.res.res1, (t(out("dec2.deconv", 32)),
                                          t(out("enc1", 32))),
                          out("dec2.res.res1", 32)),
        "dec2.res.res2": (dec2.res.res2, (t(out("dec2.res.res1", 32)),),
                          out("dec2", 32)),
        "dec1.deconv": (dec1.deconv, (t(out("dec2", 32)),),
                        out("dec1.deconv", 16)),
        "dec1.res.res1": (dec1.res.res1, (t(out("dec1.deconv", 16)), t(stem)),
                          out("dec1.res.res1", 16)),
        "dec1.res.res2": (dec1.res.res2, (t(out("dec1.res.res1", 16)),),
                          out("dec1", 16)),
        "head": (m.conv10, (t(out("dec1", 16)),), out("head", 16)),
    }
    with torch.inference_mode():
        for name, (mod, args, want) in cases.items():
            got = mod(*args).numpy()
            assert got.shape == want.shape, name
            off = np.abs(got - want) > 1e-6 * np.abs(want) + \
                1e-4 * np.abs(want).max()
            if off.any():
                print(f"{name}: {int(off.sum())} of {off.size} outputs "
                      f"off by up to {np.abs(got - want).max()} (flips)")
            assert not off.any(), name


def test_int8_forward_matches_jax(setup):
    sd, model, qvars, batches = setup
    q = qvars[0.0]
    x = batches[0]
    fwd = jax.jit(lambda v, x: _jax_int8(model).apply(v, x, train=False))
    want = np.asarray(fwd(q, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(sd, quant_scales_from_jax(q["quant"]))(
            torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, HW, HW, 3)
    d = np.abs(got - want)
    within = float((d <= 1e-4 * np.abs(want).max()).mean())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"log-probs within 1e-4·max: {within}; argmax {agree}; "
          f"max |Δ| {d.max()} of max {np.abs(want).max()}")
    assert within == 1.0 and agree >= 0.999


def test_int8_close_to_f32(setup):
    """(c) int8 vs the port's own f32 forward, both calibrations."""
    sd, _, _, batches = setup
    x = torch.from_numpy(batches[0])
    with torch.inference_mode():
        ref = _port(sd, policy=Policy.f32())(x).exp().numpy()
        for pct in (0.0, 99.9):
            m = _port(sd)
            m.set_quant_scales(calibrate(m, batches, percentile=pct))
            got = m(x).exp().numpy()
            assert np.abs(got - ref).mean() < 0.02, pct
            assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.95, pct


def test_int8_zone_routing(setup):
    """The int8 zone is JAX's packed zone: stem (plain integer conv —
    no kernel shape, as XLA in JAX), enc1, dec2, dec1, head (K1-s8); the
    classifier stays on bf16 K1; no kernel launch counted on the CPU."""
    sd, _, qvars, batches = setup
    m = _port(sd, quant_scales_from_jax(qvars[0.0]["quant"]),
              policy=Policy.int8())
    assert m.conv1.quant and not m.conv1.kernel
    assert m.conv10.quant and m.conv10.kernel
    assert m.conv11.kernel and not m.conv11.quant
    zone = [m.enc[0].res1, m.enc[0].res2]
    for dec in m.dec[-2:]:
        zone += [dec.deconv, dec.res.res1, dec.res.res2]
    assert all(b.quant for b in zone)
    rest = [b for s in m.enc[1:] for b in (s.res1, s.res2)]
    rest += [b for d in m.dec[:-2] for b in (d.deconv, d.res.res1, d.res.res2)]
    assert not any(b.quant for b in rest)
    ops.reset_launch_counts()
    with torch.inference_mode():
        lp = m(torch.from_numpy(batches[0]))
    assert lp.dtype == torch.float32 and torch.isfinite(lp).all()
    torch.testing.assert_close(lp.exp().sum(-1), torch.ones(2, HW, HW))
    assert set(ops.launch_counts().values()) == {0}


def test_int8_guards(setup):
    """quant_eval without scales raises (as JAX's ConvBN does); so do a
    width JAX would run unpacked and a depth without the packed zone."""
    sd, _, _, batches = setup
    m = _port(sd)
    with pytest.raises(ValueError, match="calibrat"):
        m(torch.from_numpy(batches[0]))
    with pytest.raises(ValueError, match="multiple of 16"):
        m(torch.zeros(1, 64, 56, 1))
    shallow = random_state_dict(seed=0, depth=4)
    with pytest.raises(ValueError, match="depth 5"):
        UResNet(shallow, policy=INT8_F32, device="cpu")
    assert calibrate(_port(shallow, policy=Policy.f32()),
                     [batches[0]])  # f32 models calibrate at any depth
