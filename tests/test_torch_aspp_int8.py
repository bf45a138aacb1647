"""int8 PTQ of the port's ASPP-ResNet against the JAX package's, float32
on the CPU, flagship width (inplanes 16, branches 16), seeded ASPP
weights (deploy/weights.py:random_state_dict(seed=2, arch=
"aspp_resnet")) that both packages load.

(a) Calibration: the port's ``calibrate`` against JAX's ``calibrate``,
    names and values, at abs-max and percentile 99.9 on 64x64 batches,
    and at percentile 99.9 on one 512x512 image — there dec2's block
    input, (1, 256, 256, 64), passes 2^20 elements and the percentile's
    strided subsample strides the W axis JAX packs: at ASPP's pack 8 the
    grid is JAX's, at UResNet's pack 4 for dec2 it is not.
(b) The int8 forward with JAX's scales (``quant_scales_from_jax``)
    against JAX's ASPPResNet under Policy(pack 8, f32, quant_eval,
    fused_eval), its Pallas int8 kernels in interpret mode, at the bar
    of tests/test_torch_int8_model.py: every log-prob within 1e-4·max,
    argmax on ≥ 99.9% of pixels.
(c) The int8 forward against the port's own f32 forward.

Tolerance of (a): the deep stages and ASPP's branches are float32
convolutions summed in another order than XLA's, so a scale, a maximum
over such activations, may differ by some ulp: 2e-6 relative, as the
UResNet calibration test holds it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_aspp import jax_aspp
from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import import_aspp_state_dict
from ubresnet_tpu.ops.quant import calibrate as jax_calibrate
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.synthetic import synth_event
from ubresnet_tpu_torch.deploy.weights import (
    quant_scales_from_jax,
    random_state_dict,
)
from ubresnet_tpu_torch.models import ASPPResNet
from ubresnet_tpu_torch.ops import quant
from ubresnet_tpu_torch.ops.quant import calibrate

torch.set_num_threads(1)

HW = 64
INT8_F32 = dataclasses.replace(Policy.f32(), fused_eval=True, quant_eval=True)
JAX_F32 = JaxPolicy(pack_width=8, compute_dtype=jnp.float32)
N_SCALES = 57 + 15  # UResNet's layers and ASPP's 3 x (4 branches + combine)


def _events(rng, n, hw):
    return np.stack([synth_event(rng, hw)["wire"] for _ in range(n)])[
        ..., None].astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    sd = random_state_dict(seed=2, arch="aspp_resnet")
    variables = import_aspp_state_dict({k: v.numpy() for k, v in sd.items()})
    rng = np.random.RandomState(7)
    batches = [_events(rng, 2, (HW, HW)) for _ in range(2)]
    model = jax_aspp(16, JAX_F32)
    qvars = {pct: jax_calibrate(model, variables, batches, percentile=pct)
             for pct in (0.0, 99.9)}
    return sd, model, qvars, batches


def _port(sd, scales=None, policy=INT8_F32):
    m = ASPPResNet(sd, policy=policy, device="cpu")
    if scales is not None:
        m.set_quant_scales(scales)
    return m


def _worst(got, want):
    assert set(got) == set(want)
    worst = max(abs(float(got[k]) - float(want[k])) / float(want[k])
                for k in want)
    print(f"max relative scale difference {worst}")
    return worst


@pytest.mark.parametrize("pct", [0.0, 99.9], ids=["absmax", "p99.9"])
def test_calibrated_scales_match_jax(setup, pct):
    sd, _, qvars, batches = setup
    want = quant_scales_from_jax(qvars[pct]["quant"])
    got = calibrate(_port(sd), batches, percentile=pct)
    assert len(want) == N_SCALES
    assert {k for k in want if k.startswith("aspp")} == {
        f"aspp{i}.b{b}" for i in (3, 4, 5) for b in (1, 2, 3, 4)} | {
        f"aspp{i}_post.post" for i in (3, 4, 5)}
    assert _worst(got, want) <= 2e-6
    assert all(float(s) > 0 for s in got.values())


def test_percentile_calibration_reads_jax_pack(setup):
    """One 512x512 image at percentile 99.9: every scale JAX's, where
    dec2's block input is subsampled on JAX's pack-8 grid; the same
    layer's range on UResNet's pack-4 grid differs."""
    sd, model, _, _ = setup
    x = _events(np.random.RandomState(11), 1, (512, 512))
    want = quant_scales_from_jax(jax_calibrate(
        model, import_aspp_state_dict({k: v.numpy() for k, v in sd.items()}),
        [x], percentile=99.9)["quant"])
    port = _port(sd)
    inputs = {}
    cal = port.calibration_model()
    cal.observe(lambda name, t, pk: inputs.setdefault(name, (t.clone(), pk)))
    with torch.inference_mode():
        cal(torch.from_numpy(x))
    t, pk = inputs["dec2.res.res1.cb1"]
    assert pk == 8 and t.numel() > 3 * quant.CALIB_CAP
    at = {p: float(quant.calib_batch_range(quant.packed_view(t, p), 99.9))
          for p in (4, 8)}
    assert at[4] != at[8]
    got = calibrate(port, [x], percentile=99.9)
    assert _worst(got, want) <= 2e-6


def _jax_int8(model):
    return model.clone(policy=dataclasses.replace(
        JAX_F32, quant_eval=True, fused_eval=True))


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


def test_int8_zone_and_close_to_f32(setup):
    """The int8 zone is UResNet's (stem, enc1, dec2, dec1, head); ASPP's
    layers and the deep stages stay float; the int8 forward is close to
    the port's own f32 forward at both calibrations."""
    sd, _, _, batches = setup
    m = _port(sd)
    assert m.conv1.quant and m.conv10.quant and not m.conv11.quant
    zone = [m.enc[0].res1, m.enc[0].res2]
    for dec in m.dec[-2:]:
        zone += [dec.deconv, dec.res.res1, dec.res.res2]
    assert all(b.quant for b in zone)
    rest = [c for a in m.aspp for c in a.branches] + list(m.combine)
    rest += [b for s in m.enc[1:] for b in (s.res1, s.res2)]
    rest += [b for d in m.dec[:-2] for b in (d.deconv, d.res.res1,
                                              d.res.res2)]
    assert not any(b.quant for b in rest)
    x = torch.from_numpy(batches[0])
    with torch.inference_mode():
        ref = _port(sd, policy=Policy.f32())(x).exp().numpy()
        for pct in (0.0, 99.9):
            m.set_quant_scales(calibrate(m, batches, percentile=pct))
            got = m(x).exp().numpy()
            print(pct, np.abs(got - ref).mean(),
                  (got.argmax(-1) == ref.argmax(-1)).mean())
            assert np.abs(got - ref).mean() < 0.02, pct
            assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.95, pct
