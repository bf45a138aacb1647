"""The port's sparse transfer helpers (ubresnet_tpu_torch/ops/sparse.py)
against the JAX package's on the same numpy images: identical COO on
the host, identical dense images from the device scatter, pad slots
harmless, -1 sentinel in mask_indices."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.ops import sparse as jsp
from ubresnet_tpu_torch.ops import sparse as tsp

torch.set_num_threads(1)


def _images(seed, b=3, h=24, w=40, occupancy=0.05):
    rng = np.random.RandomState(seed)
    img = rng.rand(b, h, w).astype(np.float32) * 50
    img[rng.rand(b, h, w) > occupancy] = 0.0
    img[0, 0, 0] = 7.0  # pixel (0, 0) is real: pad slots must not touch it
    return img


@pytest.mark.parametrize("capacity,bucket", [(None, 64), (None, 4096), (16, 64)])
def test_sparsify_densify_match_jax(capacity, bucket):
    img = _images(0)
    sp_t = tsp.sparsify(img, capacity=capacity, bucket=bucket)
    sp_j = jsp.sparsify(img, capacity=capacity, bucket=bucket)
    np.testing.assert_array_equal(sp_t["indices"], sp_j["indices"])
    np.testing.assert_array_equal(sp_t["values"], sp_j["values"])
    dense_t = tsp.densify(torch.from_numpy(sp_t["indices"]),
                          torch.from_numpy(sp_t["values"]), img.shape[1:])
    dense_j = jsp.densify(jnp.asarray(sp_j["indices"]),
                          jnp.asarray(sp_j["values"]), img.shape[1:])
    assert dense_t.shape == (3, 24, 40, 1)
    np.testing.assert_array_equal(dense_t.numpy(), np.asarray(dense_j))
    if capacity is None:  # nothing truncated: the round trip is exact
        np.testing.assert_array_equal(dense_t.numpy()[..., 0], img)
    assert sp_t["indices"].shape[1] == (capacity or jsp.round_capacity(
        int((img != 0).reshape(3, -1).sum(1).max()), bucket))


def test_mask_indices_and_round_capacity_match_jax():
    mask = _images(1) != 0
    for cap in (None, 8):
        a = tsp.mask_indices(mask, capacity=cap, bucket=32)
        b = jsp.mask_indices(mask, capacity=cap, bucket=32)
        np.testing.assert_array_equal(a, b)
        assert (a[a < 0] == -1).all()
    for n in (0, 1, 4095, 4096, 4097, 10 ** 6):
        assert tsp.round_capacity(n) == jsp.round_capacity(n)
