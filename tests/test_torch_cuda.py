"""The port's Hopper kernels on the card, against their plain PyTorch
versions on the same bf16 inputs, at ragged shapes (tile edges inside
and at the border of the image), and the model and runner on the card.

Marked ``cuda``: each test skips without an NVIDIA card. On the card:
    python -m pytest tests/test_torch_cuda.py -m cuda -q
Tolerance: one bf16 rounding step of the output, ≤ 1e-2·max|plain|
(f32 sums in another order); the max pool is exact. The train kernels'
f32 outputs (K5's sums, K6's, K9's and K10's dW, K7) are sums in another order:
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
    # conv1's sums grow as sqrt(9 cin): at 8 channels g1 a step larger,
    # so m still reaches the grid's top and saturates there
    g1, b1 = _gain(dev, co, 1e-3 * max(1.0, 16 / cin) ** 0.5, 1)
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
                      "deconv2x_s8": 0, "conv_s2k4": 0, "deconv_dw": 0,
                      "deconv2x_bwd": 0}
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


# K6's tile walk: a pixel count that is a multiple of neither its tile
# nor its grid (an odd number of tiles, 1x1 runs and 16x16 blocks alike,
# on an even number of blocks), and more tiles than its grid holds in
# its ring at once
DW_WALKS = [(3, 37, 37), (8, 512, 512)]


@pytest.mark.parametrize("bhw", DW_WALKS, ids=["B3-37x37", "B8-512x512"])
@pytest.mark.parametrize("shape", sorted(conv.DW_SHAPES))
def test_conv_dw_kernel_walk(dev, bhw, shape):
    """K6 at every compiled (ci, co, k) on a ragged batch (the last tile
    and the last round of the grid cut short) and on one whose tiles
    outnumber its blocks x ring stages (every stage reused): f32 dW
    within 1e-4·max|plain|, the same bits on a second launch."""
    bsz, *hw = bhw
    ci, co, k = shape
    g = conv.dw_grid(ci, co, k, bsz, *hw, dev)
    blocks = g["cluster_blocks"] * g["clusters"]
    if bsz == 3:
        assert (bsz * hw[0] * hw[1]) % g["tile_pixels"] and g["tiles"] % 2
        assert g["tiles"] % blocks
    else:
        assert g["tiles"] > blocks * g["stages"]
    x = _rand(dev, bsz, *hw, ci, relu=True)
    dy = _rand(dev, bsz, *hw, co, scale=0.1)
    got = conv.conv_dw(x, dy, k)
    _close_f32(got, conv.conv_dw_plain(x, dy, k), 1e-4)
    assert torch.equal(got, conv.conv_dw(x, dy, k))


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(conv.DW_SHAPES))
def test_conv_dw_kernel(dev, hw, shape):
    ci, co, k = shape
    x = _rand(dev, 2, *hw, ci, relu=True)
    dy = _rand(dev, 2, *hw, co, scale=0.1)
    _close_f32(conv.conv_dw(x, dy, k), conv.conv_dw_plain(x, dy, k), 1e-4)


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(train_conv.SHAPES)
                         + [(16, 3, 7), (16, 4, 7)])
def test_conv_input_grad_kernel(dev, hw, shape):
    """K1 at the transposed shapes: dx of each train-zone conv and of
    the classifiers (3 channels zero-padded to 4, or 4)."""
    ci, co, k = shape
    dy = _rand(dev, 2, *hw, co, scale=0.1)
    w = _rand(dev, k, k, ci, co, scale=0.05)
    wt = w.float().flip((0, 1)).transpose(2, 3)
    want = conv.conv_bn_act_plain(dy, wt, torch.ones(ci, device=dev),
                                  torch.zeros(ci, device=dev), act=False)
    _close(conv.conv_input_grad(dy, w), want)


@pytest.mark.parametrize("classes", [3, 4])
@pytest.mark.parametrize("n", [(2, 20, 37), (3, 33, 16)])
def test_weighted_nll_kernels(dev, n, classes):
    g = torch.Generator().manual_seed(sum(n))
    logits = (torch.randn(*n, classes, generator=g) * 3).to(dev)
    labels = torch.randint(0, classes, n, generator=g).to(dev, torch.int32)
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
        "deconv_dw": 0, "deconv2x_bwd": 0}
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


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("shape", sorted(deconv.BWD_SHAPES))
def test_deconv2x_bwd_kernel(dev, hw, shape):
    """K10 at every compiled (ci, co), ragged tiles at both edges: dx
    within one bf16 step and dW within 1e-4·max|plain| of its plain
    version, the same bits on a second launch."""
    ci, co = shape
    x = _rand(dev, 2, *hw, ci, relu=True)
    dy = _rand(dev, 2, 2 * hw[0], 2 * hw[1], co, scale=0.1)
    w = _rand(dev, 4, 4, ci, co, scale=0.1)
    dx, dw = deconv.deconv2x_bwd(x, dy, w)
    pdx, pdw = deconv.deconv2x_bwd_plain(x, dy, w)
    _close(dx, pdx)
    _close_f32(dw, pdw, 1e-4)
    again = deconv.deconv2x_bwd(x, dy, w)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])


@pytest.mark.parametrize("bhw", PERSISTENT, ids=["B4-256x200", "B1-20x37"])
@pytest.mark.parametrize("shape", sorted(deconv.BWD_SHAPES))
def test_deconv2x_bwd_kernel_persistent(dev, bhw, shape):
    """K10 at every compiled (ci, co) with more (and fewer) x tiles than
    its persistent grid of clusters (x B4 256x200: dy 512x400): right
    against the plain version, dx and dW the same bits on a second
    launch, and equal to K8's dx and within K9's distance of its dW."""
    bsz, *hw = bhw
    ci, co = shape
    x = _rand(dev, bsz, *hw, ci, relu=True)
    dy = _rand(dev, bsz, 2 * hw[0], 2 * hw[1], co, scale=0.1)
    w = _rand(dev, 4, 4, ci, co, scale=0.1)
    dx, dw = deconv.deconv2x_bwd(x, dy, w)
    pdx, pdw = deconv.deconv2x_bwd_plain(x, dy, w)
    _close(dx, pdx)
    _close_f32(dw, pdw, 1e-4)
    again = deconv.deconv2x_bwd(x, dy, w)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    assert torch.equal(dx, deconv.conv_s2k4(dy, w))  # K8's GEMM, same order
    _close_f32(dw, deconv.deconv_dw(x, dy), 1e-4)


@pytest.mark.parametrize("shape", sorted(deconv.BWD_SHAPES))
def test_deconv2x_ad_through_k10_matches_cudnn_autograd(dev, shape):
    """deconv2x_ad's forward (K3) and backward (K10) on bf16 card
    tensors against F.conv_transpose2d's autograd in f32 on the same
    bf16 values (TF32 off): y, dx and the bf16-rounded dW each within
    one bf16 step of its largest magnitude; one K3 and one K10 launch,
    no K8 or K9."""
    import torch.nn.functional as F

    ci, co = shape
    x = _rand(dev, 2, 24, 40, ci, relu=True)
    w = _rand(dev, 4, 4, ci, co, scale=0.1)
    dy = _rand(dev, 2, 48, 80, co, scale=0.1)
    ops.reset_launch_counts()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = deconv.deconv2x_ad(xr, wr)
    gx, gw = torch.autograd.grad(y, (xr, wr), dy)
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "deconv2x": 1, "deconv2x_bwd": 1}
    xf = x.float().permute(0, 3, 1, 2).requires_grad_()
    wf = w.float().permute(2, 3, 0, 1).requires_grad_()
    yf = F.conv_transpose2d(xf, wf, stride=2, padding=1)
    fx, fw = torch.autograd.grad(yf, (xf, wf), dy.float().permute(0, 3, 1, 2))
    for got, want in ((y, yf.permute(0, 2, 3, 1)), (gx, fx.permute(0, 2, 3, 1)),
                      (gw, fw.permute(2, 3, 0, 1))):
        got, want = got.detach(), want.detach()
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = float((got.float() - want).abs().max())
        assert err <= 1e-2 * float(want.abs().max()), err


def test_deconv_ad_train_step_on_the_card(dev):
    """One bf16 step with fused_train_deconv: the zone's table plus K3
    2 and K10 2 (no K8 or K9), a finite loss, and the dec1 upsample's
    weight moved."""
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
        "basic_block_s8": 0, "deconv2x_s8": 0, "conv_s2k4": 0,
        "deconv_dw": 0, "deconv2x_bwd": 2}
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


def test_root_precropped_on_the_card_equals_uevt(dev, tmp_path):
    """larcv .root in and out on the card: the same crops as .root and
    as .uevt, scored by one bf16 kernel-zone model, give the same
    float32 scores bit for bit (the forward does not see the format),
    with 11 launches a batch either way."""
    from ubresnet_tpu_torch.data.rootio import open_event_file, uevt_to_root
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
    from ubresnet_tpu_torch.deploy import PrecroppedRunner
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model

    src = make_synthetic_file(str(tmp_path / "in.uevt"), n_events=5,
                              hw=(256, 256), seed=4)
    uevt_to_root(src, str(tmp_path / "in.root"))
    sd = random_state_dict(seed=3)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-4
    runner = PrecroppedRunner(get_model("uresnet", sd, device=dev),
                              batch_size=2, score_dtype=np.float16)
    zone = {"conv_bn_act": 2, "basic_block": 6, "deconv2x": 2,
            "maxpool3x3s2": 1}
    scores = {}
    for ext in ("uevt", "root"):
        ops.reset_launch_counts()
        runner.run(str(tmp_path / f"in.{ext}"), str(tmp_path / f"o.{ext}"))
        assert {k: v for k, v in ops.launch_counts().items() if v} == {
            k: 3 * v for k, v in zone.items()}
        r = open_event_file(str(tmp_path / f"o.{ext}"))
        scores[ext] = [np.stack([im.pixels for im in r.read_entry(i)[
            "uburn_plane2"]], -1) for i in range(len(r))]
    assert len(scores["root"]) == 5
    for s_root, s_uevt in zip(scores["root"], scores["uevt"]):
        assert s_root.dtype == np.float32 and s_uevt.dtype == np.float16
        np.testing.assert_allclose(s_root.sum(-1), 1.0, atol=1e-2)
        np.testing.assert_array_equal(s_root.astype(np.float16), s_uevt)


def _aspp_input(dev, b=2, hw=(64, 96)):
    rng = np.random.RandomState(4)
    x = np.zeros((b, *hw, 1), np.float32)
    n = hw[0] * hw[1] // 16
    for i in range(b):
        x[i, rng.randint(0, hw[0], n), rng.randint(0, hw[1], n), 0] = \
            rng.rand(n) * 50 + 5
    return torch.from_numpy(x).to(dev)


def test_aspp_forward_on_the_card(dev):
    """ASPP-ResNet at the flagship width: the forward through the zone
    kernels — UResNet's 11 launches, K1 2, K2 6, K3 2, K4 1 — against
    the same model on the plain versions (fused_eval off): probability
    sums 1 ± 1e-3, argmax on ≥ 99% of pixels."""
    import dataclasses

    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model

    sd = random_state_dict(seed=3, arch="aspp_resnet")
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-5
    x = _aspp_input(dev)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = get_model("aspp_resnet", sd, device=dev)(x)
        counts = ops.launch_counts()
        want = get_model("aspp_resnet", sd, device=dev, policy=(
            dataclasses.replace(Policy(), fused_eval=False)))(x)
    assert {k: v for k, v in counts.items() if v} == {
        "conv_bn_act": 2, "basic_block": 6, "deconv2x": 2, "maxpool3x3s2": 1}
    assert got.shape == want.shape == (2, 64, 96, 3)
    torch.testing.assert_close(got.exp().sum(-1), torch.ones(2, 64, 96,
                                                             device=dev),
                               rtol=0, atol=1e-3)
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= 0.99


def test_aspp_int8_forward_on_the_card(dev):
    """The int8 ASPP forward: the int8 zone's launches per forward (K1-s8
    1, K2-s8 6, K3-s8 2, K4 1, K1 1) and, on the same scales, the argmax
    of the int8 plain versions on ≥ 99% of pixels."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import get_model
    from ubresnet_tpu_torch.ops.quant import calibrate

    sd = random_state_dict(seed=3, arch="aspp_resnet")
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-5
    x = _aspp_input(dev)
    model = get_model("aspp_resnet", sd, policy=Policy.int8(), device=dev)
    model.set_quant_scales(calibrate(model, [x]))
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = model(x)
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "conv_bn_act_s8": 1, "basic_block_s8": 6, "deconv2x_s8": 2,
        "maxpool3x3s2": 1, "conv_bn_act": 1}
    swaps = [(conv, "conv_bn_act", conv.conv_bn_act_plain),
             (conv, "conv_bn_act_s8", conv.conv_bn_act_s8_plain),
             (block, "basic_block_s8", block.basic_block_s8_plain),
             (deconv, "deconv2x_s8", deconv.deconv2x_s8_plain),
             (pool, "maxpool3x3s2", pool.maxpool3x3s2_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, fn in swaps:
            setattr(m, n, fn)
        with torch.inference_mode():
            want = model(x)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    assert float((got.argmax(-1) == want.argmax(-1)).float().mean()) >= 0.99


@pytest.mark.parametrize("inplanes", [32, 8, 4])
def test_int8_off_the_kernels_on_the_card(dev, inplanes):
    """int8 at widths other than the flagship's. Each int8 layer, fed on
    the card the input it got in a CPU forward, takes JAX's route
    (models/blocks.py ``_fused_form``): where JAX fuses, the layer
    launches its kernel once and gives the CPU's bits (a shape with no
    compiled kernel would raise naming it: no plain stand-in on the
    card); where JAX leaves its fused kernel (the per-conv XLA route),
    it gives the CPU's bits and launches nothing. At every width each
    layer JAX fuses launches a kernel — at 8 and 4 the 8-channel
    instances among them — and the whole forward runs with its
    launches exact."""
    from ubresnet_tpu_torch.core.precision import Policy
    from ubresnet_tpu_torch.data.synthetic import synth_event
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models import UResNet
    from ubresnet_tpu_torch.models.blocks import BasicBlock, ConvBN, Deconv2x
    from ubresnet_tpu_torch.ops.quant import calibrate

    sd = random_state_dict(seed=2, inplanes=inplanes)
    rng = np.random.RandomState(7)
    x = np.stack([synth_event(rng, (64, 64))["wire"]
                  for _ in range(2)])[..., None].astype(np.float32)
    cpu = UResNet(sd, policy=Policy.int8(), device="cpu")
    card = UResNet(sd, policy=Policy.int8(), device=dev)
    scales = calibrate(cpu, [x])
    cpu.set_quant_scales(scales)
    card.set_quant_scales(scales)
    layers = {n: m for n, m in cpu.named_modules()
              if isinstance(m, (BasicBlock, ConvBN, Deconv2x))
              and getattr(m, "quant", False)}
    seen = {}

    def keep(name):
        def hook(mod, args, kwargs):
            seen[name] = (args, kwargs)
        return hook

    handles = [m.register_forward_pre_hook(keep(n), with_kwargs=True)
               for n, m in layers.items()]
    with torch.inference_mode():
        cpu(torch.from_numpy(x))
    for h in handles:
        h.remove()

    def route(m, args):
        if isinstance(m, BasicBlock):
            dual = args[1] if len(args) > 1 else None
            return "kernel" if m._fused_form(args[0], dual) else "per_conv"
        if isinstance(m, ConvBN):
            return "kernel" if m._fused_form(args[0].shape[2]) else "xla"
        h, w = args[0].shape[1:3]
        exact = len(args) < 2 or tuple(args[1]) == (2 * h, 2 * w)
        return "kernel" if exact and m._fused_form(w) else "xla"

    card_mods = dict(card.named_modules())
    got_routes = {}

    def on_card(t):
        return t.to(dev) if isinstance(t, torch.Tensor) else t

    with torch.inference_mode():
        for n, (args, kwargs) in seen.items():
            m = layers[n]
            r = route(m, args)
            if r == "per_conv":  # its ConvBNs are checked one by one
                continue
            if r == "kernel" and not m.kernel:
                r = "raise"
            got_routes[n] = r
            dargs = [on_card(a) for a in args]
            dkw = {k: on_card(v) for k, v in kwargs.items()}
            ops.reset_launch_counts()
            if r == "raise":
                with pytest.raises(ValueError, match="kernel has no"):
                    card_mods[n](*dargs, **dkw)
                continue
            y = card_mods[n](*dargs, **dkw)
            torch.cuda.synchronize()
            launched = sum(ops.launch_counts().values())
            assert launched == (1 if r == "kernel" else 0), (n, r)
            assert torch.equal(y.cpu(), m(*args, **kwargs)), n
        ops.reset_launch_counts()
        y = card(torch.from_numpy(x).to(dev))
        torch.cuda.synchronize()
        assert torch.isfinite(y).all()
        assert ops.launch_counts() == {
            **{k: 0 for k in ops.launch_counts()},
            **{32: {"maxpool3x3s2": 1, "basic_block_s8": 6,
                    "deconv2x_s8": 1, "conv_bn_act": 1},
               8: {"basic_block_s8": 6, "conv_bn_act_s8": 1,
                   "deconv2x_s8": 2, "conv_bn_act": 1},
               4: {"basic_block_s8": 3, "conv_bn_act_s8": 3,
                   "deconv2x_s8": 2, "conv_bn_act": 1}}[inplanes]}
    counts = {r: sum(v == r for v in got_routes.values())
              for r in ("kernel", "raise", "xla")}
    assert counts == {32: {"kernel": 7, "raise": 0, "xla": 3},
                      8: {"kernel": 9, "raise": 0, "xla": 1},
                      4: {"kernel": 8, "raise": 0, "xla": 7}}[inplanes], \
        got_routes


def test_bf16_fused_layer_off_shapes_raises(dev):
    """A bf16 layer whose route says JAX fuses it but whose shape no
    kernel was compiled for raises on the card naming its kernel, and launches nothing: a ConvBN (32, 8, 3)
    at the lane pack 4 and a BasicBlock (16, 0, 64, proj) at 8."""
    from ubresnet_tpu_torch.models.blocks import BasicBlock, ConvBN

    g = torch.Generator().manual_seed(0)

    def bn(sd, key, c):
        sd[f"{key}.weight"] = torch.rand(c, generator=g) + 0.5
        sd[f"{key}.bias"] = torch.randn(c, generator=g) * 0.1
        sd[f"{key}.running_mean"] = torch.zeros(c)
        sd[f"{key}.running_var"] = torch.ones(c)

    sd = {"c.weight": torch.randn(8, 32, 3, 3, generator=g) * 0.1}
    bn(sd, "bn", 8)
    conv = ConvBN(sd, "c", "bn", qpack=4, device=dev)
    for cin, co, k, key in ((16, 64, 3, "b.conv1"), (64, 64, 3, "b.conv2"),
                            (16, 64, 1, "b.bypass")):
        sd[f"{key}.weight"] = torch.randn(co, cin, k, k, generator=g) * 0.1
    for key in ("b.bn1", "b.bn2", "b.bnpass"):
        bn(sd, key, 64)
    blk = BasicBlock(sd, "b", qpack=8, device=dev)
    assert conv._fused_form(16) and (32, 8, 3) not in ops.conv.SHAPES
    ops.reset_launch_counts()
    for layer, c in ((conv, 32), (blk, 16)):
        x = torch.rand(2, 16, 16, c, generator=g).to(dev, torch.bfloat16)
        with pytest.raises(ValueError, match="kernel has no"):
            layer(x)
    assert set(ops.launch_counts().values()) == {0}
