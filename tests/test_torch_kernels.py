"""The port's kernel wrappers (ubresnet_tpu_torch/ops) against the JAX
Pallas kernels they replace, on the CPU: the wrappers take their plain
PyTorch versions for CPU tensors, the Pallas kernels run in interpret
mode on W-packed tensors exactly as tests/test_pallas_conv.py runs
them. Same numpy inputs to both, float32. Tolerances follow
test_pallas_conv.py: 2e-5 for single convs (f32 reduction order),
2e-4 for the two-conv blocks, bit-exact for the max pool."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.ops.packed import pack, tile_channel_vector, unpack
from ubresnet_tpu.ops.pallas_conv import (
    fused_basic_block,
    fused_dual_block,
    fused_packed_conv,
    fused_packed_deconv2x,
    fused_pool3x3s2,
)
from ubresnet_tpu_torch.ops import (
    basic_block,
    conv_bn_act,
    deconv2x,
    maxpool3x3s2,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _affine(rng, co):
    return ((rng.rand(co) + 0.5).astype(np.float32),
            (rng.randn(co) * 0.1).astype(np.float32))


@pytest.mark.parametrize(
    "p,ci,co,k,res,clf",
    [
        (8, 16, 16, 3, False, False),
        (4, 32, 32, 3, True, False),
        (8, 16, 16, 7, False, False),   # head conv10 form
        (8, 16, 16, 7, True, False),
        (8, 16, 3, 7, False, True),     # classifier conv11 form
    ],
)
def test_conv_bn_act_matches_pallas(rng, p, ci, co, k, res, clf):
    B, H, W = 2, 16, 16 * p  # H 16: the 7x7 halo needs >= 2 row tiles of 4
    x = rng.randn(B, H, W, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    g, b = _affine(rng, co)
    if clf:  # classifier: g = 1, b = conv bias, no ReLU
        g = np.ones(co, np.float32)
    r = rng.randn(B, H, W, co).astype(np.float32) if res else None
    act = not clf
    want = unpack(fused_packed_conv(
        pack(jnp.asarray(x), p), jnp.asarray(w),
        jnp.tile(jnp.asarray(g), p), jnp.tile(jnp.asarray(b), p), p=p,
        residual=pack(jnp.asarray(r), p) if res else None,
        act=act, pre_act=res, th=4, interpret=True), p)
    got = conv_bn_act(_t(x), _t(w), _t(g), _t(b),
                      _t(r) if res else None, pre_act=res, act=act)
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def _block_args(rng, cin, co, proj):
    w1 = (rng.randn(3, 3, cin, co) * 0.1).astype(np.float32)
    w2 = (rng.randn(3, 3, co, co) * 0.1).astype(np.float32)
    wb = (rng.randn(1, 1, cin, co) * 0.1).astype(np.float32) if proj else None
    (g1, b1), (g2, b2), (gb, bb) = (_affine(rng, co) for _ in range(3))
    return w1, g1, b1, w2, g2, b2, wb, gb, bb


@pytest.mark.parametrize(
    "p,ci,co,proj",
    [(8, 16, 32, True),    # enc1.res1 form
     (4, 32, 32, False),   # enc1.res2 / dec2.res.res2 form
     (8, 16, 16, False)],  # dec1.res.res2 form
)
def test_basic_block_matches_pallas(rng, p, ci, co, proj):
    B, H, W = 2, 8, 8 * p
    x = np.abs(rng.randn(B, H, W, ci)).astype(np.float32)
    w1, g1, b1, w2, g2, b2, wb, gb, bb = _block_args(rng, ci, co, proj)
    j = jnp.asarray
    want = unpack(fused_basic_block(
        pack(j(x), p), j(w1), tile_channel_vector(j(g1), p),
        tile_channel_vector(j(b1), p), j(w2), tile_channel_vector(j(g2), p),
        tile_channel_vector(j(b2), p), j(wb) if proj else None,
        tile_channel_vector(j(gb), p) if proj else None,
        tile_channel_vector(j(bb), p) if proj else None,
        p=p, th=4, interpret=True), p)
    got = basic_block(
        _t(x), None, _t(w1), _t(g1), _t(b1), _t(w2), _t(g2), _t(b2),
        _t(wb[0, 0]) if proj else None, _t(gb) if proj else None,
        _t(bb) if proj else None)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("p,ci,co", [(4, 32, 32), (8, 16, 16)])
def test_dual_block_matches_pallas(rng, p, ci, co):
    """K2 over [a, b] (dec2/dec1 res.res1 forms) ≡ fused_dual_block."""
    B, H, W = 2, 8, 8 * p
    a = rng.randn(B, H, W, ci).astype(np.float32)
    b = rng.randn(B, H, W, ci).astype(np.float32)
    w1, g1, b1, w2, g2, b2, wb, gb, bb = _block_args(rng, 2 * ci, co, True)
    j, tcv = jnp.asarray, tile_channel_vector
    want = unpack(fused_dual_block(
        pack(j(a), p), pack(j(b), p),
        j(w1), tcv(j(g1), p), tcv(j(b1), p),
        j(w2), tcv(j(g2), p), tcv(j(b2), p),
        j(wb), tcv(j(gb), p), tcv(j(bb), p),
        p=p, th=4, interpret=True), p)
    got = basic_block(_t(a), _t(b), _t(w1), _t(g1), _t(b1), _t(w2), _t(g2),
                      _t(b2), _t(wb[0, 0]), _t(gb), _t(bb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


@pytest.mark.parametrize("p,ci,co,H,W",
                         [(4, 64, 32, 8, 64), (8, 32, 16, 8, 128),
                          (8, 16, 16, 8, 64)])
def test_deconv2x_matches_pallas(rng, p, ci, co, H, W):
    """K3 ≡ fused_packed_deconv2x; the weight is (kh, kw, ci, co), the
    reference IOHW permuted (2, 3, 0, 1), in both."""
    x = rng.randn(2, H, W, ci).astype(np.float32)
    w = (rng.randn(4, 4, ci, co) * 0.1).astype(np.float32)
    want = unpack(fused_packed_deconv2x(
        pack(jnp.asarray(x), p), jnp.asarray(w), p=p, th=4,
        interpret=True), p)
    got = deconv2x(_t(x), _t(w))
    assert got.shape == want.shape == (2, 2 * H, 2 * W, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("p,ci,H,W", [(8, 16, 16, 128), (4, 32, 16, 64)])
def test_maxpool3x3s2_matches_pallas(rng, p, ci, H, W):
    """K4 ≡ fused_pool3x3s2 on its non-negative domain, bit-exact."""
    x = np.abs(rng.randn(2, H, W, ci)).astype(np.float32)
    want = unpack(fused_pool3x3s2(pack(jnp.asarray(x), p), p=p, th=4,
                                  interpret=True), p)
    got = maxpool3x3s2(_t(x))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On a non-CPU tensor a wrapper launches its kernel or raises; an
    uncompiled shape (24 channels, which no UResNet of the port runs)
    raises before any build or launch."""
    meta = torch.empty((1, 8, 8, 24), device="meta")
    with pytest.raises(ValueError, match="conv_bn_act kernel has no"):
        conv_bn_act(meta, torch.empty((3, 3, 24, 24), device="meta"),
                    torch.empty(24, device="meta"),
                    torch.empty(24, device="meta"))
    with pytest.raises(ValueError, match="deconv2x kernel has no"):
        deconv2x(meta, torch.empty((4, 4, 24, 24), device="meta"))
    with pytest.raises(ValueError, match="basic_block kernel has no"):
        w = torch.empty((3, 3, 24, 24), device="meta")
        v = torch.empty(24, device="meta")
        basic_block(meta, None, w, v, v, w, v, v)
