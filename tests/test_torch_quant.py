"""The port's int8 PTQ pieces (ubresnet_tpu_torch/ops/quant.py) against
the JAX package's ops/quant.py on the same numpy inputs: weight scales,
weight and activation quantization bit-exact (.5 ties and the ±127 clip
included), the calibration range exact at abs-max and within 1e-6
relative at percentiles 99.9 / 99.99 — also above 2^20 elements, where
both subsample the W-packed view on the same strided grid."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.ops import quant as jq
from ubresnet_tpu.ops.packed import pack
from ubresnet_tpu_torch.ops import quant

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_weight_scales_and_quantize_weight_bit_exact(rng):
    for shape in ((7, 7, 16, 16), (3, 3, 64, 32), (1, 1, 16, 32),
                  (4, 4, 32, 16)):
        w = (rng.randn(*shape) * 0.1).astype(np.float32)
        w[..., 0] = 0.0  # an all-zero channel takes the eps floor
        sw_j = np.asarray(jq.weight_scales(jnp.asarray(w)))
        sw = quant.weight_scales(_t(w))
        np.testing.assert_array_equal(sw.numpy(), sw_j)
        np.testing.assert_array_equal(
            quant.quantize_weight(_t(w), sw).numpy(),
            np.asarray(jq.quantize_weight(jnp.asarray(w), jnp.asarray(sw_j))))


def test_quantize_act_bit_exact_with_ties_and_clip(rng):
    sx = np.float32(0.5)
    ties = (np.arange(-260, 261) * 0.25).astype(np.float32)  # k/4 / 0.5
    x = np.concatenate([ties, (rng.randn(10000) * 40).astype(np.float32),
                        np.array([-1e6, 1e6, 63.25, 63.75, -0.25, 0.25],
                                 np.float32)])
    got = quant.quantize_act(_t(x), _t(sx)).numpy()
    want = np.asarray(jq.quantize_act(jnp.asarray(x), jnp.asarray(sx)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int8 and got.max() == 127 and got.min() == -127
    # half to even: 0.25 / 0.5 = 0.5 → 0, 0.75 / 0.5 = 1.5 → 2
    assert list(quant.quantize_act(_t(np.float32([0.25, 0.75, 1.25])),
                                   _t(sx)).numpy()) == [0, 2, 2]


@pytest.mark.parametrize("pct", [0.0, 99.9, 99.99])
@pytest.mark.parametrize("shape,p", [((2, 16, 32, 16), 8),
                                     ((1, 24, 40, 32), 4),
                                     ((3, 8, 8, 64), 1)])
def test_calib_batch_range_small(rng, shape, p, pct):
    """Below 2^20 elements: post-ReLU-like tensors (mostly zeros)."""
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32) * 3
    got = float(quant.calib_batch_range(quant.packed_view(_t(x), p), pct))
    want = float(jq.calib_batch_range(pack(jnp.asarray(x), p) if p > 1
                                      else jnp.asarray(x), pct))
    if pct == 0.0:
        assert got == want
    else:
        assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("pct", [0.0, 99.9, 99.99])
def test_calib_batch_range_subsampled_packed_view(rng, pct):
    """Above 2^20 elements (2 x 96 x 128 x 64 = 1.57 M): the strided-grid
    subsample runs on the packed (b, h, w/p, p·c) view, as JAX
    calibrates a packed layer."""
    x = np.maximum(rng.randn(2, 96, 128, 64), 0).astype(np.float32)
    x *= rng.rand(2, 96, 128, 1).astype(np.float32) * 10
    view = quant.packed_view(_t(x), 4)
    assert view.shape == (2, 96, 32, 256) and view.numel() > quant.CALIB_CAP
    got = float(quant.calib_batch_range(view, pct))
    want = float(jq.calib_batch_range(pack(jnp.asarray(x), 4), pct))
    if pct == 0.0:
        assert got == want
    else:
        assert abs(got - want) <= 1e-6 * want
        # the percentile of the whole tensor is another number: the
        # subsample ran, on the grid JAX uses
        ax = view.abs().flatten()
        whole = float(torch.quantile(ax[ax > 0][:(1 << 24) - 1],
                                     pct / 100.0))
        assert abs(whole - got) > 1e-6 * want


def test_calib_batch_range_semantics():
    """0 → abs-max; P → percentile of NONZERO |x|; all-zero → 0 (the
    JAX package's tests/test_quant.py cases)."""
    x = _t(np.float32([0.0, 0.0, 0.0, -1.0, 2.0, -3.0, 100.0]))
    assert float(quant.calib_batch_range(x)) == 100.0
    assert float(quant.calib_batch_range(x, 50.0)) == pytest.approx(2.5)
    assert float(quant.calib_batch_range(torch.zeros(8), 99.0)) == 0.0
    assert float(quant.calib_batch_range(torch.zeros(8))) == 0.0


@pytest.mark.parametrize("ci,k", [(16, 3), (1, 7)],
                         ids=["f64-conv", "unfold-matmul"])
def test_int_conv_exact(ci, k):
    """The plain integer conv is exact — float64 and rounded, or for a
    small reduction (the 1-channel 7x7 stem) unfold + float32 matmul —
    against an int64 reference built from shifted products."""
    rng = np.random.RandomState(3)
    x = rng.randint(-127, 128, (2, 9, 11, ci)).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, ci, 4)).astype(np.int8)
    x[0, 4:] = 127  # the largest sums the stem can form
    w[..., 0] = 127
    r = k // 2
    got = quant.int_conv2d(_t(x), _t(w), r).numpy()
    xp = np.pad(x.astype(np.int64), ((0, 0), (r, r), (r, r), (0, 0)))
    want = sum(np.einsum("bhwc,cd->bhwd", xp[:, i:i + 9, j:j + 11],
                         w[i, j].astype(np.int64))
               for i in range(k) for j in range(k))
    np.testing.assert_array_equal(got, want.astype(np.float32))


def test_int_conv_transpose_exact():
    rng = np.random.RandomState(4)
    x = rng.randint(-127, 128, (1, 9, 11, 16)).astype(np.int8)
    wd = rng.randint(-127, 128, (4, 4, 16, 4)).astype(np.int8)
    up = quant.int_conv_transpose2d(_t(x), _t(wd)).numpy()
    ref = np.zeros((1, 20, 24, 4), np.int64)  # out[2i + k - 1] += w[k] x[i]
    for kh in range(4):
        for kw in range(4):
            contrib = np.einsum("bhwc,cd->bhwd", x.astype(np.int64),
                                wd[kh, kw].astype(np.int64))
            ref[:, kh:kh + 18:2, kw:kw + 22:2] += contrib
    np.testing.assert_array_equal(up, ref[:, 1:19, 1:23].astype(np.float32))
