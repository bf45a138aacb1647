"""The port's UResNet (ubresnet_tpu_torch/models) against the JAX
package's UResNet and against the torch-functional oracle of the
reference (parity/torch_oracle.py), float32 on the CPU, inplanes 16.

Weights come from one seeded reference-format state_dict: the JAX
model imports it (deploy/importers.py) and the port takes the JAX
variables back through ``state_dict_from_jax``; the oracle comparison
loads the same weights from a ``.tar`` through
``load_reference_checkpoint``. Bound: |Δ| ≤ 1e-5·max|ref| (the
bound test_pallas_conv.py uses between two f32 paths of the full
model) and identical per-pixel argmax."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import import_uresnet_state_dict
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu.parity.torch_oracle import make_state_dict, torch_uresnet_eval
from ubresnet_tpu_torch import ops
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.deploy.weights import (
    load_reference_checkpoint,
    save_reference_checkpoint,
    state_dict_from_jax,
)
from ubresnet_tpu_torch.models import UResNet

torch.set_num_threads(1)

F32 = Policy.f32()
F32_FUSED = dataclasses.replace(Policy.f32(), fused_eval=True)


@pytest.fixture(scope="module")
def weights():
    sd = make_state_dict(np.random.RandomState(0), inplanes=16)
    return sd, import_uresnet_state_dict({k: v.numpy() for k, v in sd.items()})


def _input(seed, h, w):
    return np.random.RandomState(seed).rand(1, h, w, 1).astype(np.float32)


def _jax_logits(variables, x):
    model = jax_get_model("uresnet", policy=JaxPolicy.f32(), input_channels=1,
                          inplanes=16)
    fwd = jax.jit(lambda v, x: model.apply(v, x, train=False, logits=True))
    return np.asarray(fwd(variables, jnp.asarray(x)))


def _close(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    assert float((got.argmax(-1) == want.argmax(-1)).mean()) == 1.0


@pytest.mark.parametrize("policy", [F32, F32_FUSED], ids=["f32", "f32-zone"])
@pytest.mark.parametrize("hw", [(64, 64), (60, 68)], ids=["64x64", "60x68"])
def test_uresnet_matches_jax(weights, policy, hw):
    """Unfused and kernel-zone (plain versions on the CPU) forwards ≡
    JAX UResNet under Policy.f32(); 60x68 exercises the non-2x decoder
    targets (output_padding + crop) and odd encoder shapes."""
    _, variables = weights
    x = _input(1, *hw)
    want = _jax_logits(variables, x)
    model = UResNet(state_dict_from_jax(variables), policy=policy,
                    device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(x), logits=True).numpy()
    assert got.shape == want.shape == (1, *hw, 3)
    _close(got, want)


def test_kernel_zone_routing(weights):
    """At the flagship width the kernel zone is exactly the 11 layers
    of the JAX Pallas zone: K1 x2, K2 x6, K3 x2, K4 x1 per forward."""
    sd, _ = weights
    model = UResNet(sd, policy=F32_FUSED, device="cpu")
    assert model.conv10.kernel and model.conv11.kernel
    assert not model.conv1.kernel
    zone = [model.enc[0].res1, model.enc[0].res2]
    for dec in model.dec[-2:]:
        zone += [dec.res.res1, dec.res.res2]
        assert dec.deconv.kernel
    assert all(b.kernel for b in zone)
    others = [b for stage in model.enc[1:] for b in (stage.res1, stage.res2)]
    others += [b for dec in model.dec[:-2] for b in (dec.res.res1, dec.res.res2)]
    assert not any(b.kernel for b in others)
    assert not any(dec.deconv.kernel for dec in model.dec[:-2])
    assert not any(b.kernel for b in UResNet(sd, policy=F32, device="cpu")
                   .enc[0].children())


def test_uresnet_matches_torch_oracle(weights, tmp_path):
    """Port log-probs ≡ torch_uresnet_eval on weights read back from a
    reference-format .tar (module. prefix stripped, geometry inferred)."""
    sd, _ = weights
    path = str(tmp_path / "ref.tar")
    save_reference_checkpoint({f"module.{k}": v for k, v in sd.items()}, path)
    loaded, info = load_reference_checkpoint(path)
    assert info["inplanes"] == 16 and info["num_classes"] == 3
    assert info["input_channels"] == 1
    x = _input(2, 64, 64)
    with torch.inference_mode():
        want = torch_uresnet_eval(sd, torch.from_numpy(x).permute(0, 3, 1, 2))
        want = want.permute(0, 2, 3, 1).numpy()
        got = UResNet(loaded, policy=F32, device="cpu")(torch.from_numpy(x))
    _close(got.numpy(), want)


def test_bf16_policy_runs_the_zone_on_cpu(weights):
    """The default (bf16, kernel zone) policy on the CPU: plain versions
    of the kernels, finite normalized probabilities close to f32, and no
    kernel launch counted."""
    sd, _ = weights
    x = torch.from_numpy(_input(3, 64, 64))
    ops.reset_launch_counts()
    with torch.inference_mode():
        lp = UResNet(sd, device="cpu")(x)
        ref = UResNet(sd, policy=F32, device="cpu")(x)
    assert lp.dtype == torch.float32 and torch.isfinite(lp).all()
    torch.testing.assert_close(lp.exp().sum(-1), torch.ones(1, 64, 64))
    assert float((lp.argmax(-1) == ref.argmax(-1)).float().mean()) > 0.9
    assert set(ops.launch_counts().values()) == {0}
