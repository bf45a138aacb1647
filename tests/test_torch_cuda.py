"""The port's Hopper kernels on the card, against their plain PyTorch
versions on the same bf16 inputs, at ragged shapes (tile edges inside
and at the border of the image), and the model and runner on the card.

Marked ``cuda``: each test skips without an NVIDIA card. On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda -q
Tolerance: one bf16 rounding step of the output, ≤ 1e-2·max|plain|
(f32 sums in another order); the max pool is exact."""
import numpy as np
import pytest
import torch

from ubresnet_tpu_torch import ops
from ubresnet_tpu_torch.ops import block, conv, deconv, pool

pytestmark = pytest.mark.cuda

HW = [(20, 37), (33, 16)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run with -m cuda on the card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(dev, *shape, scale=1.0, relu=False):
    g = torch.Generator().manual_seed(sum(shape) * 7 + len(shape))
    t = torch.randn(*shape, generator=g) * scale
    return (torch.relu(t) if relu else t).to(dev, torch.bfloat16)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(want.float().abs().max())


@pytest.mark.parametrize("hw", HW)
def test_maxpool_kernel(dev, hw):
    x = _rand(dev, 2, *hw, 16)
    got = pool.maxpool3x3s2(x)
    torch.testing.assert_close(got, pool.maxpool3x3s2_plain(x), rtol=0, atol=0)


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(conv.SHAPES))
def test_conv_kernel(dev, hw, shape):
    ci, co, k = shape
    x = _rand(dev, 2, *hw, ci, relu=True)
    w = _rand(dev, k, k, ci, co, scale=0.05)
    g = torch.rand(co, device=dev) + 0.5
    b = torch.randn(co, device=dev) * 0.1
    r = _rand(dev, 2, *hw, co)
    for res, pre, act in ((None, False, True), (None, False, False),
                          (r, True, True)):
        _close(conv.conv_bn_act(x, w, g, b, res, pre_act=pre, act=act),
               conv.conv_bn_act_plain(x, w, g, b, res, pre_act=pre, act=act))


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(block.SHAPES))
def test_block_kernel(dev, hw, shape):
    ca, cb, co, proj = shape
    cin = ca + cb
    a = _rand(dev, 2, *hw, ca, relu=True)
    b = _rand(dev, 2, *hw, cb, relu=True) if cb else None
    aff = [torch.rand(co, device=dev) + 0.5 if i % 2 == 0
           else torch.randn(co, device=dev) * 0.1 for i in range(6)]
    args = (a, b, _rand(dev, 3, 3, cin, co, scale=0.1), aff[0], aff[1],
            _rand(dev, 3, 3, co, co, scale=0.1), aff[2], aff[3],
            _rand(dev, cin, co, scale=0.1) if proj else None,
            aff[4] if proj else None, aff[5] if proj else None)
    _close(block.basic_block(*args), block.basic_block_plain(*args))


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(deconv.SHAPES))
def test_deconv_kernel(dev, hw, shape):
    ci, co = shape
    x = _rand(dev, 2, *hw, ci)
    w = _rand(dev, 4, 4, ci, co, scale=0.1)
    _close(deconv.deconv2x(x, w), deconv.deconv2x_plain(x, w))


def test_kernels_refuse_f32(dev):
    x = torch.zeros(1, 8, 8, 16, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        pool.maxpool3x3s2(x)


def test_model_on_the_card(dev):
    """bf16 kernel path vs f32 plain path on the card: 11 launches per
    forward, finite normalized scores, argmax agreement ≥ 0.98."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model

    sd = random_state_dict(seed=1)
    x = torch.from_numpy(
        np.random.RandomState(0).rand(2, 64, 64, 1).astype(np.float32)).to(dev)
    ops.reset_launch_counts()
    with torch.inference_mode():
        lp = get_model("uresnet", sd, device=dev)(x)
        counts = ops.launch_counts()
        ref = get_model("uresnet", sd, policy=Policy.f32(), device=dev)(x)
    assert counts == {"conv_bn_act": 2, "basic_block": 6, "deconv2x": 2,
                      "maxpool3x3s2": 1}
    assert torch.isfinite(lp).all()
    torch.testing.assert_close(lp.exp().sum(-1),
                               torch.ones(2, 64, 64, device=dev))
    assert float((lp.argmax(-1) == ref.argmax(-1)).float().mean()) >= 0.98
