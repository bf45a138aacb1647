"""The port's train-zone kernels (their plain versions, as the wrappers
run them on CPU tensors) against the JAX Pallas kernels they replace,
which run in interpret mode on W-packed tensors exactly as
tests/test_pallas_conv.py, tests/test_pallas_loss.py and
tests/test_pool_ad.py run them. Same numpy inputs to both, float32,
the JAX tests' own cases and tolerances:

  * K5 train_conv_stats vs pallas_train.train_conv_stats (#7): y, the
    sums and the grads of x, w and bias through a loss on y, s1 and s2
    (rtol 2e-4 on the loss; rtol 1e-4 with atol 1e-4 / 1e-3 / 1e-3 on
    the grads);
  * conv_ad vs pallas_conv.pallas_conv_ad (#8), incl. the co = 3
    classifier (rtol 2e-5 forward; 1e-4/1e-4 dx, 1e-4/1e-3 dW);
  * K6 conv_dw vs pallas_conv.pallas_conv_dw (#9) (rtol 1e-4, atol 1e-3);
  * K7 weighted_nll vs pallas_loss.pallas_weighted_nll (#6) (rtol 1e-5
    forward; rtol 1e-4, atol 1e-6 grad);
  * maxpool3x3s2_ad vs pool_ad.packed_pool_ad (#13) and
    pool_ad.maxpool3x3s2_ad: bit-exact forward and grads, with ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.ops.packed import pack, unpack
from ubresnet_tpu.ops.pallas_conv import pallas_conv_ad, pallas_conv_dw
from ubresnet_tpu.ops.pallas_loss import pallas_weighted_nll
from ubresnet_tpu.ops.pallas_train import train_conv_stats as jax_tcs
from ubresnet_tpu.ops.pool_ad import maxpool3x3s2_ad as jax_pool_ad
from ubresnet_tpu.ops.pool_ad import packed_pool_ad
from ubresnet_tpu_torch.ops.conv import conv_ad, conv_dw
from ubresnet_tpu_torch.ops.loss import weighted_nll
from ubresnet_tpu_torch.ops.pool import maxpool3x3s2_ad
from ubresnet_tpu_torch.ops.train_conv import train_conv_stats

torch.set_num_threads(1)

H, WC = 16, 32  # the JAX tests' packed tile: W = WC * p unpacked


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("k,ci,co,p,bias", [(3, 16, 16, 8, False),
                                            (3, 32, 16, 4, True),
                                            (7, 16, 16, 8, True),
                                            (1, 32, 32, 4, False)])
def test_train_conv_stats_matches_pallas(rng, k, ci, co, p, bias):
    x = rng.randn(2, H, WC * p, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    b = rng.randn(co).astype(np.float32) if bias else None
    r = rng.randn(2, H, WC * p, co).astype(np.float32)
    c1 = rng.randn(co).astype(np.float32)
    c2 = (rng.randn(co) * 0.01).astype(np.float32)
    r_p, c1_p, c2_p = pack(jnp.asarray(r), p), jnp.tile(c1, p), jnp.tile(c2, p)

    def loss_jax(x, w, b):
        y, s1, s2 = jax_tcs(x, w, b, p, True)
        return jnp.sum(y * r_p) + jnp.sum(s1 * c1_p) + jnp.sum(s2 * c2_p)

    argnums = (0, 1, 2) if bias else (0, 1)
    jb = jnp.asarray(b) if bias else None
    want_loss, want_g = jax.value_and_grad(loss_jax, argnums)(
        pack(jnp.asarray(x), p), jnp.asarray(w), jb)
    y_j, s1_j, s2_j = jax_tcs(pack(jnp.asarray(x), p), jnp.asarray(w), jb,
                              p, True)

    tx, tw = _t(x, True), _t(w, True)
    tb = _t(b, True) if bias else None
    y, s1, s2 = train_conv_stats(tx, tw, tb)
    loss = (y * _t(r)).sum() + (s1 * _t(c1)).sum() + (s2 * _t(c2)).sum()
    loss.backward()
    _close(y.detach(), unpack(y_j, p), 1e-5, 1e-5)
    _close(s1.detach(), s1_j.reshape(p, co).sum(0), 1e-4, 1e-3)
    _close(s2.detach(), s2_j.reshape(p, co).sum(0), 1e-4, 1e-3)
    _close(loss.item(), float(want_loss), 2e-4)
    _close(tx.grad, unpack(want_g[0], p), 1e-4, 1e-4)
    _close(tw.grad, want_g[1], 1e-4, 1e-3)
    if bias:
        _close(tb.grad, want_g[2], 1e-4, 1e-3)


@pytest.mark.parametrize("k,ci,co,p", [(3, 16, 16, 8), (3, 32, 16, 4),
                                       (7, 16, 16, 8), (1, 32, 32, 4),
                                       (7, 16, 3, 8)])
def test_conv_ad_matches_pallas(rng, k, ci, co, p):
    x = rng.randn(2, H, WC * p, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.1).astype(np.float32)
    r = rng.randn(2, H, WC * p, co).astype(np.float32)
    r_p = pack(jnp.asarray(r), p)
    want, (dx_j, dw_j) = jax.value_and_grad(
        lambda x, w: jnp.sum(pallas_conv_ad(x, w, p, True) * r_p), (0, 1))(
        pack(jnp.asarray(x), p), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    loss = (conv_ad(tx, tw) * _t(r)).sum()
    loss.backward()
    _close(loss.item(), float(want), 2e-5)
    _close(tx.grad, unpack(dx_j, p), 1e-4, 1e-4)
    _close(tw.grad, dw_j, 1e-4, 1e-3)


@pytest.mark.parametrize("k,ci,co,p", [(3, 16, 16, 8), (3, 32, 16, 4),
                                       (7, 16, 16, 8), (1, 32, 32, 4),
                                       (7, 16, 3, 8), (3, 8, 12, 16),
                                       (1, 32, 16, 4), (7, 16, 4, 8)])
def test_conv_dw_matches_pallas(rng, k, ci, co, p):
    x = rng.randn(2, H, WC * p, ci).astype(np.float32)
    dy = rng.randn(2, H, WC * p, co).astype(np.float32)
    want = pallas_conv_dw(pack(jnp.asarray(x), p), pack(jnp.asarray(dy), p),
                          p=p, kw=k, th=4, interpret=True)
    got = conv_dw(_t(x), _t(dy), k)
    assert got.shape == (k, k, ci, co) and got.dtype == torch.float32
    _close(got, want, 1e-4, 1e-3)


def _nll_data(rng, b=2, h=64, w=128, c=3):
    return (rng.randn(b, h, w, c).astype(np.float32) * 3,
            rng.randint(0, c, (b, h, w)).astype(np.int32),
            rng.rand(b, h, w).astype(np.float32) * 2)


def test_weighted_nll_matches_pallas(rng):
    logits, labels, weights = _nll_data(rng)
    j = jnp.asarray
    want, want_g = jax.value_and_grad(
        lambda lg: pallas_weighted_nll(lg, j(labels), j(weights), True))(
        j(logits))
    tl = _t(logits, True)
    loss = weighted_nll(tl, torch.from_numpy(labels), _t(weights))
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    _close(loss.item(), float(want), 1e-5)
    _close(tl.grad, want_g, 1e-4, 1e-6)


def _pool_loss_grads(x, r):
    tx = _t(x, True)
    y = maxpool3x3s2_ad(tx)
    (y * _t(r)).sum().backward()
    return y.detach().numpy(), tx.grad.numpy()


@pytest.mark.parametrize("dense", [0.1, 0.5])
def test_pool_ad_matches_packed_pool_ad(rng, dense):
    """Integer-valued, mostly equal input: nearly every window has tied
    maxima. Forward and grads bit-exact to packed_pool_ad (p = 8,
    p·ci = 128, its non-negative domain)."""
    p, ci = 8, 16
    x = ((rng.rand(2, 16, 16 * p, ci) < dense)
         * rng.randint(1, 4, (2, 16, 16 * p, ci))).astype(np.float32)
    r = rng.randint(-3, 4, (2, 8, 8 * p, ci)).astype(np.float32)
    r_p = pack(jnp.asarray(r), p)
    y_j = unpack(packed_pool_ad(pack(jnp.asarray(x), p), p, True), p)
    g_j = unpack(jax.grad(
        lambda xp: jnp.sum(packed_pool_ad(xp, p, True) * r_p))(
        pack(jnp.asarray(x), p)), p)
    y, g = _pool_loss_grads(x, r)
    np.testing.assert_array_equal(y, np.asarray(y_j))
    np.testing.assert_array_equal(g, np.asarray(g_j))


def test_pool_ad_matches_dense_vjp(rng):
    """Against the unpacked dense-backward VJP at a narrow ragged
    channel count, with random cotangents: the same sums in the same
    order, bit-exact."""
    x = ((rng.rand(2, 12, 20, 3) > 0.7) * rng.randint(1, 3, (2, 12, 20, 3))
         ).astype(np.float32)
    r = rng.randn(2, 6, 10, 3).astype(np.float32)
    g_j = jax.grad(lambda x: jnp.sum(jax_pool_ad(x) * jnp.asarray(r)))(
        jnp.asarray(x))
    y, g = _pool_loss_grads(x, r)
    np.testing.assert_array_equal(y, np.asarray(jax_pool_ad(jnp.asarray(x))))
    np.testing.assert_array_equal(g, np.asarray(g_j))
