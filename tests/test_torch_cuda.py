"""The port's Hopper kernels on the card, against their plain PyTorch
versions on the same bf16 inputs, at ragged shapes (tile edges inside
and at the border of the image), and the model and runner on the card.

Marked ``cuda``: each test skips without an NVIDIA card. On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda -q
Tolerance: one bf16 rounding step of the output, ≤ 1e-2·max|plain|
(f32 sums in another order); the max pool is exact. The train kernels'
f32 outputs (K5's sums, K6's and K9's dW, K7) are sums in another order:
within 1e-4·max|plain| (K5's sums are over the bf16 y, which may round
one step apart, hence 1e-3 for them)."""
import numpy as np
import pytest
import torch

from ubresnet_tpu_torch import ops
from ubresnet_tpu_torch.ops import block, conv, deconv, loss, pool, train_conv

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
    args = _block_args(dev, 2, hw, shape)
    _close(block.basic_block(*args), block.basic_block_plain(*args))


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(deconv.SHAPES))
def test_deconv_kernel(dev, hw, shape):
    ci, co = shape
    x = _rand(dev, 2, *hw, ci)
    w = _rand(dev, 4, 4, ci, co, scale=0.1)
    _close(deconv.deconv2x(x, w), deconv.deconv2x_plain(x, w))


# K2 and K3 walk their tiles in a persistent grid (SMs x blocks per SM):
# B=4 at 256x200 gives more tiles than the grid holds (and a ragged last
# tile column), B=1 at 20x37 fewer.
PERSISTENT = [(4, 256, 200), (1, 20, 37)]


def _block_args(dev, bsz, hw, shape):
    ca, cb, co, proj = shape
    cin = ca + cb
    a = _rand(dev, bsz, *hw, ca, relu=True)
    b = _rand(dev, bsz, *hw, cb, relu=True) if cb else None
    aff = [torch.rand(co, device=dev) + 0.5 if i % 2 == 0
           else torch.randn(co, device=dev) * 0.1 for i in range(6)]
    return (a, b, _rand(dev, 3, 3, cin, co, scale=0.1), aff[0], aff[1],
            _rand(dev, 3, 3, co, co, scale=0.1), aff[2], aff[3],
            _rand(dev, cin, co, scale=0.1) if proj else None,
            aff[4] if proj else None, aff[5] if proj else None)


@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(block.SHAPES))
def test_block_kernel_persistent(dev, bhw, shape):
    """K2 at more (and fewer) tiles than its grid: right against the
    plain version, and two launches give the same bits."""
    bsz, *hw = bhw
    args = _block_args(dev, bsz, hw, shape)
    got = block.basic_block(*args)
    _close(got, block.basic_block_plain(*args))
    assert torch.equal(got, block.basic_block(*args))


@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(deconv.SHAPES))
def test_deconv_kernel_persistent(dev, bhw, shape):
    """K3 at more (and fewer) tiles than its grid: right against the
    plain version, and two launches give the same bits."""
    bsz, *hw = bhw
    ci, co = shape
    x = _rand(dev, bsz, *hw, ci)
    w = _rand(dev, 4, 4, ci, co, scale=0.1)
    got = deconv.deconv2x(x, w)
    _close(got, deconv.deconv2x_plain(x, w))
    assert torch.equal(got, deconv.deconv2x(x, w))


@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(conv.SHAPES))
def test_conv_kernel_persistent(dev, bhw, shape):
    """K1 at every compiled (ci, co, k) with more (and fewer) tiles than
    its persistent grid: right against the plain version with the
    residual, pre-ReLU and ReLU, and two launches give the same bits."""
    bsz, *hw = bhw
    ci, co, k = shape
    x = _rand(dev, bsz, *hw, ci, relu=True)
    w = _rand(dev, k, k, ci, co, scale=0.05)
    g = torch.rand(co, device=dev) + 0.5
    b = torch.randn(co, device=dev) * 0.1
    r = _rand(dev, bsz, *hw, co)
    got = conv.conv_bn_act(x, w, g, b, r, pre_act=True)
    _close(got, conv.conv_bn_act_plain(x, w, g, b, r, pre_act=True))
    assert torch.equal(got, conv.conv_bn_act(x, w, g, b, r, pre_act=True))


@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(conv.DW_SHAPES))
def test_conv_dw_kernel_persistent(dev, bhw, shape):
    """K6 at every compiled (ci, co, k) with more (and fewer) tiles than
    its persistent grid: f32 dW within 1e-4·max|plain| (sums in another
    order), and the same bits on a second launch."""
    bsz, *hw = bhw
    ci, co, k = shape
    x = _rand(dev, bsz, *hw, ci, relu=True)
    dy = _rand(dev, bsz, *hw, co, scale=0.1)
    got = conv.conv_dw(x, dy, k)
    _close_f32(got, conv.conv_dw_plain(x, dy, k), 1e-4)
    assert torch.equal(got, conv.conv_dw(x, dy, k))


def _s8(dev, *shape, lo=-127, hi=128):
    g = torch.Generator().manual_seed(sum(shape) * 11 + len(shape))
    return torch.randint(lo, hi, shape, generator=g,
                         dtype=torch.int8).to(dev)


def _gain(dev, co, scale, seed):
    g = torch.Generator().manual_seed(seed)
    return ((torch.randn(co, generator=g).abs() * scale).to(dev),
            (torch.randn(co, generator=g) * 3).to(dev))


def _s8_close(got, want, out_dtype):
    """float32 outputs bit-identical (exact s32 sums, the same f32
    epilogue steps); bf16 outputs within one bf16 step."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == out_dtype
    if out_dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        _close(got, want)


S8_OUT = [torch.float32, torch.bfloat16]


def _block_s8_args(dev, bsz, hw, shape):
    ca, cb, co, proj = shape
    cin = ca + cb
    a = _s8(dev, bsz, *hw, ca)
    b = _s8(dev, bsz, *hw, cb) if cb else None
    g1, b1 = _gain(dev, co, 1e-3, 1)
    g2, b2 = _gain(dev, co, 1e-3, 2)
    if proj:
        gb, bb = _gain(dev, co, 1e-3, 3)
    else:
        gb = torch.full((co,), 0.05, device=dev)
        bb = torch.zeros(co, device=dev)
    return (a, b, _s8(dev, 3, 3, cin, co, lo=-64, hi=65), g1, b1,
            _s8(dev, 3, 3, co, co, lo=-64, hi=65), g2, b2,
            _s8(dev, cin, co, lo=-64, hi=65) if proj else None, gb, bb)


@pytest.mark.parametrize("out_dtype", S8_OUT, ids=["f32", "bf16"])
@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(conv.S8_SHAPES))
def test_conv_s8_kernel(dev, hw, shape, out_dtype):
    """K1-s8 at batch 16: with g = 1, b = 0 the float32 output is the
    s32 accumulator itself, exactly; then the BN epilogues."""
    ci, co, k = shape
    x = _s8(dev, 16, *hw, ci)
    w = _s8(dev, k, k, ci, co)
    ones, zeros = torch.ones(co, device=dev), torch.zeros(co, device=dev)
    acc = conv.conv_bn_act_s8(x, w, ones, zeros, act=False,
                              out_dtype=torch.float32)
    torch.testing.assert_close(
        acc, conv.conv_bn_act_s8_plain(x, w, ones, zeros, act=False,
                                       out_dtype=torch.float32),
        rtol=0, atol=0)
    g, b = _gain(dev, co, 1e-4, ci + co)
    r = torch.randn(16, *hw, co, device=dev).to(out_dtype)
    for res, pre, act in ((None, False, True), (r, True, True)):
        _s8_close(conv.conv_bn_act_s8(x, w, g, b, res, pre_act=pre, act=act,
                                      out_dtype=out_dtype),
                  conv.conv_bn_act_s8_plain(x, w, g, b, res, pre_act=pre,
                                            act=act, out_dtype=out_dtype),
                  out_dtype)


@pytest.mark.parametrize("out_dtype", S8_OUT, ids=["f32", "bf16"])
@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(block.S8_SHAPES))
def test_block_s8_kernel(dev, hw, shape, out_dtype):
    """K2-s8 at batch 16 (single and dual stream, projection and
    identity), g1 scaled so the requantized m spans the int8 grid and
    saturates at 127."""
    args = _block_s8_args(dev, 16, hw, shape)
    want, m = block.basic_block_s8_plain(*args, out_dtype=out_dtype,
                                         with_mid=True)
    assert int(m.max()) == 127 and int(m.min()) == 0
    _s8_close(block.basic_block_s8(*args, out_dtype=out_dtype), want,
              out_dtype)


@pytest.mark.parametrize("out_dtype", S8_OUT, ids=["f32", "bf16"])
@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(block.S8_SHAPES))
def test_block_s8_kernel_persistent(dev, bhw, shape, out_dtype):
    """K2-s8 at every compiled shape and output dtype with more (and
    fewer) tiles than its persistent grid: the float32 output
    bit-identical to the plain version's (bf16 within one step), m
    spanning the int8 grid, and the same bits on a second launch."""
    bsz, *hw = bhw
    args = _block_s8_args(dev, bsz, hw, shape)
    want, m = block.basic_block_s8_plain(*args, out_dtype=out_dtype,
                                         with_mid=True)
    assert int(m.max()) == 127 and int(m.min()) == 0
    got = block.basic_block_s8(*args, out_dtype=out_dtype)
    _s8_close(got, want, out_dtype)
    assert torch.equal(got, block.basic_block_s8(*args, out_dtype=out_dtype))


def _s8_same(got, want):
    """The int8 kernels' outputs, float32 or bf16, bit for bit the plain
    version's: exact s32 sums and the same f32 epilogue steps, so the
    bf16 output is the same rounding of the same float32 value."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("out_dtype", S8_OUT, ids=["f32", "bf16"])
@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(conv.S8_SHAPES))
def test_conv_s8_kernel_persistent(dev, bhw, shape, out_dtype):
    """K1-s8 at every compiled shape and output dtype with more (and
    fewer) tiles than its persistent grid: the s32 sums (g = 1, b = 0)
    and the outputs of each epilogue (ReLU; pre-ReLU, residual, ReLU;
    none) bit-identical to the plain version's, and the same bits on a
    second launch."""
    bsz, *hw = bhw
    ci, co, k = shape
    x = _s8(dev, bsz, *hw, ci)
    w = _s8(dev, k, k, ci, co)
    ones, zeros = torch.ones(co, device=dev), torch.zeros(co, device=dev)
    _s8_same(conv.conv_bn_act_s8(x, w, ones, zeros, act=False,
                                 out_dtype=torch.float32),
             conv.conv_bn_act_s8_plain(x, w, ones, zeros, act=False,
                                       out_dtype=torch.float32))
    g, b = _gain(dev, co, 1e-4, ci + co)
    r = (torch.randn(bsz, *hw, co, generator=torch.Generator().manual_seed(5))
         * 4).to(dev, out_dtype)
    for res, pre, act in ((None, False, True), (r, True, True),
                          (None, False, False)):
        got = conv.conv_bn_act_s8(x, w, g, b, res, pre_act=pre, act=act,
                                  out_dtype=out_dtype)
        _s8_same(got, conv.conv_bn_act_s8_plain(
            x, w, g, b, res, pre_act=pre, act=act, out_dtype=out_dtype))
        assert torch.equal(got, conv.conv_bn_act_s8(
            x, w, g, b, res, pre_act=pre, act=act, out_dtype=out_dtype))


@pytest.mark.parametrize("out_dtype", S8_OUT, ids=["f32", "bf16"])
@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(deconv.S8_SHAPES))
def test_deconv_s8_kernel_persistent(dev, bhw, shape, out_dtype):
    """K3-s8 at every compiled shape and output dtype with more (and
    fewer) tiles than its persistent grid: the s32 sums (g = 1) and the
    dequantized output bit-identical to the plain version's, and the
    same bits on a second launch."""
    bsz, *hw = bhw
    ci, co = shape
    x = _s8(dev, bsz, *hw, ci)
    w = _s8(dev, 4, 4, ci, co)
    ones = torch.ones(co, device=dev)
    _s8_same(deconv.deconv2x_s8(x, w, ones, out_dtype=torch.float32),
             deconv.deconv2x_s8_plain(x, w, ones, torch.float32))
    g, _ = _gain(dev, co, 1e-3, ci)
    got = deconv.deconv2x_s8(x, w, g, out_dtype=out_dtype)
    _s8_same(got, deconv.deconv2x_s8_plain(x, w, g, out_dtype))
    assert torch.equal(got, deconv.deconv2x_s8(x, w, g, out_dtype=out_dtype))


@pytest.mark.parametrize("out_dtype", S8_OUT, ids=["f32", "bf16"])
@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(deconv.S8_SHAPES))
def test_deconv_s8_kernel(dev, hw, shape, out_dtype):
    ci, co = shape
    x = _s8(dev, 16, *hw, ci)
    w = _s8(dev, 4, 4, ci, co)
    ones = torch.ones(co, device=dev)
    torch.testing.assert_close(
        deconv.deconv2x_s8(x, w, ones, out_dtype=torch.float32),
        deconv.deconv2x_s8_plain(x, w, ones, torch.float32), rtol=0, atol=0)
    g, _ = _gain(dev, co, 1e-3, ci)
    _s8_close(deconv.deconv2x_s8(x, w, g, out_dtype=out_dtype),
              deconv.deconv2x_s8_plain(x, w, g, out_dtype), out_dtype)


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
                      "maxpool3x3s2": 1, "conv_stats": 0, "conv_dw": 0,
                      "weighted_nll": 0, "weighted_nll_bwd": 0,
                      "conv_bn_act_s8": 0, "basic_block_s8": 0,
                      "deconv2x_s8": 0, "conv_s2k4": 0, "deconv_dw": 0}
    assert torch.isfinite(lp).all()
    torch.testing.assert_close(lp.exp().sum(-1),
                               torch.ones(2, 64, 64, device=dev))
    assert float((lp.argmax(-1) == ref.argmax(-1)).float().mean()) >= 0.98


def _close_f32(got, want, tol):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(train_conv.SHAPES))
def test_conv_stats_kernel(dev, hw, shape):
    ci, co, k = shape
    x = _rand(dev, 2, *hw, ci, relu=True)
    w = _rand(dev, k, k, ci, co, scale=0.05)
    b = torch.randn(co, device=dev) * 0.1
    for bias in (None, b):
        y, s1, s2 = train_conv.conv_stats(x, w, bias)
        py, p1, p2 = train_conv.conv_stats_plain(x, w, bias)
        _close(y, py)
        _close_f32(s1, p1, 1e-3)
        _close_f32(s2, p2, 1e-3)


def _stats_args(dev, bsz, hw, shape):
    ci, co, k = shape
    return (_rand(dev, bsz, *hw, ci, relu=True),
            _rand(dev, k, k, ci, co, scale=0.05),
            torch.randn(co, generator=torch.Generator().manual_seed(co)).to(
                dev) * 0.1)


def _stats_same(got, again):
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(train_conv.SHAPES))
def test_conv_stats_kernel_persistent(dev, bhw, shape):
    """K5 at every compiled (ci, co, k) with more (and fewer) tiles than
    its persistent grid: y within one bf16 step, s1 and s2 within
    1e-3·max|plain|, and y, s1 and s2 the same bits on a second
    launch."""
    bsz, *hw = bhw
    x, w, b = _stats_args(dev, bsz, hw, shape)
    got = train_conv.conv_stats(x, w, b)
    want = train_conv.conv_stats_plain(x, w, b)
    _close(got[0], want[0])
    _close_f32(got[1], want[1], 1e-3)
    _close_f32(got[2], want[2], 1e-3)
    _stats_same(got, train_conv.conv_stats(x, w, b))


# tiles per SM: below every K5 grid, at the grid of an instance that
# holds 1, 2 or 3 blocks per SM, and above every grid (one 16x16 image a
# tile)
GRID_TILES = [0.5, 1, 2, 3, 3.05]


@pytest.mark.parametrize("per_sm", GRID_TILES,
                         ids=["below", "1x", "2x", "3x", "above"])
@pytest.mark.parametrize("shape", sorted(train_conv.SHAPES))
def test_conv_stats_kernel_grid_sizes(dev, shape, per_sm):
    """K5's sums when the tile count is below, at and above its grid
    size: every block's row is written and added once, blocks with no
    tile add zeros; the same bits on a second launch."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    x, w, b = _stats_args(dev, int(per_sm * sms), (16, 16), shape)
    got = train_conv.conv_stats(x, w, b)
    want = train_conv.conv_stats_plain(x, w, b)
    _close(got[0], want[0])
    _close_f32(got[1], want[1], 1e-3)
    _close_f32(got[2], want[2], 1e-3)
    _stats_same(got, train_conv.conv_stats(x, w, b))


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(conv.DW_SHAPES))
def test_conv_dw_kernel(dev, hw, shape):
    ci, co, k = shape
    x = _rand(dev, 2, *hw, ci, relu=True)
    dy = _rand(dev, 2, *hw, co, scale=0.1)
    _close_f32(conv.conv_dw(x, dy, k), conv.conv_dw_plain(x, dy, k), 1e-4)


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(train_conv.SHAPES) + [(16, 3, 7)])
def test_conv_input_grad_kernel(dev, hw, shape):
    """K1 at the transposed shapes: dx of each train-zone conv and of
    the classifier (3 channels zero-padded to 4)."""
    ci, co, k = shape
    dy = _rand(dev, 2, *hw, co, scale=0.1)
    w = _rand(dev, k, k, ci, co, scale=0.05)
    wt = w.float().flip((0, 1)).transpose(2, 3)
    want = conv.conv_bn_act_plain(dy, wt, torch.ones(ci, device=dev),
                                  torch.zeros(ci, device=dev), act=False)
    _close(conv.conv_input_grad(dy, w), want)


@pytest.mark.parametrize("n", [(2, 20, 37), (3, 33, 16)])
def test_weighted_nll_kernels(dev, n):
    g = torch.Generator().manual_seed(sum(n))
    logits = (torch.randn(*n, 3, generator=g) * 3).to(dev)
    labels = torch.randint(0, 3, n, generator=g).to(dev, torch.int32)
    weights = (torch.rand(*n, generator=g) * 2).to(dev)
    _close_f32(loss.weighted_nll_fwd(logits, labels, weights),
               loss.weighted_nll_fwd_plain(logits, labels, weights), 1e-5)
    gl = torch.tensor(0.7, device=dev)
    _close_f32(loss.weighted_nll_bwd(logits, labels, weights, gl),
               loss.weighted_nll_bwd_plain(logits, labels, weights, gl), 1e-5)


def test_train_step_on_the_card(dev):
    """One bf16 train step with the kernel zone: the per-step launch
    table (K5 16, K1 18, K6 17, K4 1, K7 1 + 1), a finite loss, and an
    update that moved the parameters."""
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    model = get_model("uresnet", random_state_dict(seed=2), device=dev,
                      train=True)
    opt = make_optimizer(model.parameters(), "adam", 1e-3)
    rng = np.random.RandomState(0)
    batch = {"image": (rng.rand(2, 64, 64, 1) * 10).astype(np.float32),
             "label": rng.randint(0, 3, (2, 64, 64)).astype(np.int32),
             "weight": np.ones((2, 64, 64), np.float32)}
    w0 = model.conv10.weight.detach().clone()
    ops.reset_launch_counts()
    _, m = build_train_step(use_pallas_loss=True, device=dev)(
        create_train_state(model, opt), batch)
    assert ops.launch_counts() == {
        "conv_bn_act": 18, "basic_block": 0, "deconv2x": 0,
        "maxpool3x3s2": 1, "conv_stats": 16, "conv_dw": 17,
        "weighted_nll": 1, "weighted_nll_bwd": 1, "conv_bn_act_s8": 0,
        "basic_block_s8": 0, "deconv2x_s8": 0, "conv_s2k4": 0,
        "deconv_dw": 0}
    assert np.isfinite(m["loss"]) and m["nan_skipped"] == 0
    assert not torch.equal(model.conv10.weight, w0)


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(deconv.S2K4_SHAPES))
def test_conv_s2k4_kernel(dev, hw, shape):
    """K8 at every compiled (ci, co), ragged dx tiles at both edges."""
    ci, co = shape
    dy = _rand(dev, 2, 2 * hw[0], 2 * hw[1], co, scale=0.1)
    w = _rand(dev, 4, 4, ci, co, scale=0.1)
    _close(deconv.conv_s2k4(dy, w), deconv.conv_s2k4_plain(dy, w))


@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(deconv.S2K4_SHAPES))
def test_conv_s2k4_kernel_persistent(dev, bhw, shape):
    """K8 at every compiled (ci, co) with more (and fewer) dx tiles than
    its persistent grid (dx B4 256x200: dy 512x400): right against the
    plain version, and the same bits on a second launch."""
    bsz, *hw = bhw
    ci, co = shape
    dy = _rand(dev, bsz, 2 * hw[0], 2 * hw[1], co, scale=0.1)
    w = _rand(dev, 4, 4, ci, co, scale=0.1)
    got = deconv.conv_s2k4(dy, w)
    _close(got, deconv.conv_s2k4_plain(dy, w))
    assert torch.equal(got, deconv.conv_s2k4(dy, w))


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(deconv.DW_SHAPES))
def test_deconv_dw_kernel(dev, hw, shape):
    """K9 at every compiled (ci, co): f32 dW, the same bits twice."""
    ci, co = shape
    x = _rand(dev, 2, *hw, ci, relu=True)
    dy = _rand(dev, 2, 2 * hw[0], 2 * hw[1], co, scale=0.1)
    got = deconv.deconv_dw(x, dy)
    _close_f32(got, deconv.deconv_dw_plain(x, dy), 1e-4)
    assert torch.equal(got, deconv.deconv_dw(x, dy))


@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(deconv.DW_SHAPES))
def test_deconv_dw_kernel_persistent(dev, bhw, shape):
    """K9 at every compiled (ci, co) with more (and fewer) x tiles than
    its persistent grid (x B4 256x200: dy 512x400): f32 dW within
    1e-4·max|plain| (sums in another order), and the same bits on a
    second launch."""
    bsz, *hw = bhw
    ci, co = shape
    x = _rand(dev, bsz, *hw, ci, relu=True)
    dy = _rand(dev, bsz, 2 * hw[0], 2 * hw[1], co, scale=0.1)
    got = deconv.deconv_dw(x, dy)
    _close_f32(got, deconv.deconv_dw_plain(x, dy), 1e-4)
    assert torch.equal(got, deconv.deconv_dw(x, dy))


def test_deconv_ad_train_step_on_the_card(dev):
    """One bf16 step with fused_train_deconv: the zone's table plus K3
    2, K8 2, K9 2, a finite loss, and the dec1 upsample's weight
    moved."""
    import dataclasses

    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.train import (
        build_train_step,
        create_train_state,
        make_optimizer,
    )

    pol = dataclasses.replace(Policy(), fused_train_deconv=True)
    model = get_model("uresnet", random_state_dict(seed=2), policy=pol,
                      device=dev, train=True)
    opt = make_optimizer(model.parameters(), "adam", 1e-3)
    rng = np.random.RandomState(0)
    batch = {"image": (rng.rand(2, 64, 64, 1) * 10).astype(np.float32),
             "label": rng.randint(0, 3, (2, 64, 64)).astype(np.int32),
             "weight": np.ones((2, 64, 64), np.float32)}
    w0 = model.dec_layer1.deconv.weight.detach().clone()
    ops.reset_launch_counts()
    _, m = build_train_step(use_pallas_loss=True, device=dev)(
        create_train_state(model, opt), batch)
    counts = ops.launch_counts()
    assert counts == {
        "conv_bn_act": 18, "basic_block": 0, "deconv2x": 2,
        "maxpool3x3s2": 1, "conv_stats": 16, "conv_dw": 17,
        "weighted_nll": 1, "weighted_nll_bwd": 1, "conv_bn_act_s8": 0,
        "basic_block_s8": 0, "deconv2x_s8": 0, "conv_s2k4": 2,
        "deconv_dw": 2}
    assert np.isfinite(m["loss"]) and m["nan_skipped"] == 0
    assert not torch.equal(model.dec_layer1.deconv.weight, w0)


# The wholeview paths run the zone at batch 1 on the padded whole plane
# (1024x3456: full, half and quarter resolution) and at batch 10 on
# 512x832 crops; every zone layer at the plane's shapes:
PLANE = (1024, 3456)
PLANE_LAYERS = {  # layer → (kind, shape, input resolution divisor)
    "stem pool": ("pool", 16, 1),
    "enc1.res1": ("block", (16, 0, 32, True), 2),
    "enc1.res2": ("block", (32, 0, 32, False), 2),
    "dec2.deconv": ("deconv", (64, 32), 4),
    "dec2.res.res1": ("block", (32, 32, 32, True), 2),
    "dec1.deconv": ("deconv", (32, 16), 2),
    "dec1.res.res1": ("block", (16, 16, 16, True), 1),
    "dec1.res.res2": ("block", (16, 0, 16, False), 1),
    "head conv10": ("conv", (16, 16, 7), 1),
    "classifier conv11": ("conv", (16, 3, 7), 1),
}


@pytest.mark.parametrize("layer", sorted(PLANE_LAYERS))
def test_zone_kernels_at_the_whole_plane(dev, layer):
    """Each bf16 zone kernel at batch 1 on the padded whole plane
    against its plain version; for the int8 zone (K1-s8 conv10, K2-s8,
    K3-s8) the float32 output bit-identical to the plain version's."""
    kind, shape, div = PLANE_LAYERS[layer]
    hw = (PLANE[0] // div, PLANE[1] // div)
    if kind == "pool":
        x = _rand(dev, 1, *hw, shape, relu=True)
        torch.testing.assert_close(pool.maxpool3x3s2(x),
                                   pool.maxpool3x3s2_plain(x), rtol=0, atol=0)
        return
    f32 = torch.float32
    if kind == "block":
        args = _block_args(dev, 1, hw, shape)
        _close(block.basic_block(*args), block.basic_block_plain(*args))
        q = _block_s8_args(dev, 1, hw, shape)
        _s8_same(block.basic_block_s8(*q, out_dtype=f32),
                 block.basic_block_s8_plain(*q, out_dtype=f32))
    elif kind == "deconv":
        ci, co = shape
        x = _rand(dev, 1, *hw, ci)
        w = _rand(dev, 4, 4, ci, co, scale=0.1)
        _close(deconv.deconv2x(x, w), deconv.deconv2x_plain(x, w))
        xq, wq = _s8(dev, 1, *hw, ci), _s8(dev, 4, 4, ci, co)
        g, _ = _gain(dev, co, 1e-3, ci)
        _s8_same(deconv.deconv2x_s8(xq, wq, g, out_dtype=f32),
                 deconv.deconv2x_s8_plain(xq, wq, g, f32))
    else:
        ci, co, k = shape
        x = _rand(dev, 1, *hw, ci, relu=True)
        w = _rand(dev, k, k, ci, co, scale=0.05)
        g = torch.rand(co, device=dev) + 0.5
        b = torch.randn(co, device=dev) * 0.1
        act = co != 3
        _close(conv.conv_bn_act(x, w, g, b, act=act),
               conv.conv_bn_act_plain(x, w, g, b, act=act))
        if conv.s8_supports(ci, co, k):
            xq, wq = _s8(dev, 1, *hw, ci), _s8(dev, k, k, ci, co)
            gq, bq = _gain(dev, co, 1e-4, ci + co)
            _s8_same(conv.conv_bn_act_s8(xq, wq, gq, bq, out_dtype=f32),
                     conv.conv_bn_act_s8_plain(xq, wq, gq, bq,
                                               out_dtype=f32))


def test_stitch_tiles_on_the_card_bit_equal_cpu(dev):
    """Split and stitch on the card give the CPU's bits: the same adds
    in grid order, the same divide."""
    from ubresnet_tpu_torch.ops import tiling

    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.rand(1008, 3456, 3).astype(np.float32))
    grid = tiling.tile_grid(1008, 3456)
    tiles = torch.from_numpy(rng.rand(len(grid), 512, 832, 3)
                             .astype(np.float32))
    got = tiling.stitch_tiles(tiles.to(dev), grid, (1008, 3456))
    want = tiling.stitch_tiles(tiles, grid, (1008, 3456))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tiling.extract_tiles(img.to(dev), grid, 512, 832)
                       .cpu(), tiling.extract_tiles(img, grid, 512, 832))


def test_wholeview_spatial_runner_on_the_card(dev):
    """The spatial runner at batch 1 on a 96x1696 plane (48-row,
    ragged-tile half resolution): 11 launches, and the argmax of the
    plain bf16 path's runner (fused_eval off) on ≥ 99% of pixels."""
    import dataclasses

    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy import WholeViewRunner
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model

    sd = random_state_dict(seed=3)
    rng = np.random.RandomState(1)
    img = (rng.rand(96, 1696) * 60).astype(np.float32)
    img[rng.rand(96, 1696) > 0.05] = 0.0
    kernel = WholeViewRunner(get_model("uresnet", sd, device=dev),
                             spatial=True)
    plain = WholeViewRunner(get_model(
        "uresnet", sd, policy=dataclasses.replace(Policy(), fused_eval=False),
        device=dev), spatial=True)
    ops.reset_launch_counts()
    got = kernel.score_image(img)
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "conv_bn_act": 2, "basic_block": 6, "deconv2x": 2, "maxpool3x3s2": 1}
    want = plain.score_image(img)
    assert got.shape == want.shape == (96, 1696, 3)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


def test_sparse_readback_on_the_card(dev, tmp_path):
    """The precropped runner's sparse readback on the card: inside the
    halo its scores equal the dense u8 readback's bit for bit, outside
    it they are the zero-input field; 11 launches a batch, and 11 more
    once for the field at batch 1. It ships fewer bytes than dense u8."""
    import warnings

    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.data.uevt import EventFileReader
    from ubresnet_tpu_torch.deploy import PrecroppedRunner
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.sparse import dilate_mask

    path = make_synthetic_file(str(tmp_path / "in.uevt"), n_events=3,
                               hw=(256, 256), seed=2)
    sd = random_state_dict(seed=3)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-4  # unsaturated scores
    model = get_model("uresnet", sd, device=dev)
    zone = {"conv_bn_act": 2, "basic_block": 6, "deconv2x": 2,
            "maxpool3x3s2": 1}
    scores = {}
    for mode, forwards in (("u8", 2), ("sparse", 3)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            runner = PrecroppedRunner(model, batch_size=2,
                                      compact_readback=mode)
        ops.reset_launch_counts()
        runner.run(path, str(tmp_path / f"{mode}.uevt"))
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == {k: v * forwards for k, v in zone.items()}, mode
        r = EventFileReader(str(tmp_path / f"{mode}.uevt"))
        scores[mode] = np.stack([np.stack(
            [im.pixels for im in r.read_entry(i)["uburn_plane2"]], -1)
            for i in range(len(r))])
        if mode == "sparse":
            bg = runner._bg_field((256, 256))
            assert runner._out_cap < 256 * 256
    adc = EventFileReader(path)
    halo = dilate_mask(np.stack([adc.read_entry(i)["wire"][0].pixels != 0
                                 for i in range(3)]), 4)
    np.testing.assert_array_equal(scores["sparse"][halo], scores["u8"][halo])
    np.testing.assert_array_equal(
        scores["sparse"][~halo],
        np.broadcast_to(bg, scores["u8"].shape)[~halo])
