"""The port's model introspection (ubresnet_tpu_torch.utils.describe):
count_params equal to the JAX package's on the same configuration
(UResNet and ASPP-ResNet at inplanes 4, from abstract shapes: no JAX
forward), activation shapes and the layer table of the eval and
trainable models."""
import jax
import jax.numpy as jnp
import pytest
import torch

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu.utils.describe import count_params as jax_count_params
from ubresnet_tpu_torch.deploy.weights import random_state_dict
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.utils.describe import (
    activation_shapes,
    count_params,
    describe_model,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", ["uresnet", "aspp_resnet"])
def test_count_params_equals_jax(arch):
    """Conv kernels and biases and BN scales and biases, no running
    statistics: the flax ``params`` of the same configuration, from the
    reference state_dict and from the trainable model's."""
    kw = {"aspp_branch_features": 16} if arch == "aspp_resnet" else {}
    jm = jax_get_model(arch, policy=JaxPolicy.f32(), inplanes=4, **kw)
    variables = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 64, 64, 1)))
    want = jax_count_params(variables)
    sd = random_state_dict(seed=0, inplanes=4, arch=arch)
    assert count_params(sd) == want > 1e5
    model = get_model(arch, sd, device="cpu", train=True)
    assert count_params(model.state_dict()) == want


def test_activation_shapes_and_table():
    sd = random_state_dict(seed=0, inplanes=4)
    model = get_model("uresnet", sd, device="cpu")
    sh = activation_shapes(model, (1, 64, 64, 1))
    assert sh["<output>"] == (1, 64, 64, 3)
    assert sh["conv1"] == (1, 64, 64, 4) and sh["enc.4"] == (1, 2, 2, 128)
    assert len(sh) > 40
    assert activation_shapes(get_model("uresnet", sd, device="cpu",
                                       train=True), (2, 64, 64, 1))[
        "<output>"] == (2, 64, 64, 3)
    table = describe_model(model, (1, 64, 64, 1))
    lines = table.splitlines()
    assert lines[0].split() == ["module", "type", "output", "shape",
                                "elements"]
    assert lines[2].startswith("UResNet") and "(1, 64, 64, 3)" in lines[2]
    assert any(line.startswith("enc.0 ") for line in lines)
    assert not any(line.startswith("enc.0.res1.") for line in lines)
