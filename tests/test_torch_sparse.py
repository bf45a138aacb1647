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


def _generator_crops():
    """16 crops of the benchmark's own generator at its scoring traffic
    (portbench/traffic/score_512_b16.json): 512², under 1% occupied."""
    import json
    import os

    from portbench.lib import synth

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "traffic",
                           "score_512_b16.json")) as f:
        gen = json.load(f)["generator"]
    return synth.crops(np.random.RandomState(2 ** 31 + 11), 16, (512, 512),
                       gen)["image"][..., 0].astype(np.float32)


def _edge_images(case):
    """(b, h, w) float32 images of one edge case and the external
    capacity that truncates some row of it."""
    rng = np.random.RandomState(3)
    img = _images(4)
    if case == "all_zero":
        img[:] = 0.0
    elif case == "zero_row":  # an empty row beside two full ones
        img[0] = 0.0
        img[1:] = rng.uniform(1.0, 9.0, img[1:].shape)
    elif case == "full_row":  # every pixel of row 1 nonzero
        img[1] = rng.uniform(1.0, 9.0, img[1].shape)
    elif case == "tied_over_capacity":  # |value| ties decide the cut
        img[2] = np.where(rng.rand(*img[2].shape) < 0.5, 0.0,
                          rng.choice([-3.0, 3.0, 5.0, -5.0], img[2].shape))
    elif case == "negative_minus_zero":  # -0.0 is a zero, as ``!= 0``
        img = -img
        img[rng.rand(*img.shape) < 0.3] = -0.0
    elif case == "b1":  # the whole-plane runner's call
        img = img[1:2]
    elif case == "odd_shape":  # rows of 63 pixels, not a multiple of 8
        img = _images(4, h=7, w=9, occupancy=0.3)
    elif case == "generator_512":
        img = _generator_crops()
    return img, 8 if case != "generator_512" else 1500


EDGE_CASES = ["all_zero", "zero_row", "full_row", "tied_over_capacity",
              "negative_minus_zero", "b1", "odd_shape", "generator_512"]


def _same_bits(a, b):
    """Equal dtype, shape and bits: -0.0 and 0.0 differ."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("case", EDGE_CASES)
def test_sparsify_edge_cases_match_jax(case):
    """The one-bool-mask COO against the JAX package's float path: the
    same indices, values, order, padding and K, automatic and at an
    external capacity (the largest-|value| cut, ties as argsort breaks
    them); ``min_capacity`` only adds index-0 / value-0 columns."""
    img, cap = _edge_images(case)
    for kw in ({"bucket": 64}, {"bucket": 4096}, {"capacity": cap}):
        a, b = tsp.sparsify(img, **kw), jsp.sparsify(img, **kw)
        _same_bits(a["indices"], b["indices"])
        _same_bits(a["values"], b["values"])
        assert a["shape"] == b["shape"] == img.shape[1:]
    k = jsp.sparsify(img, bucket=64)["indices"].shape[1]
    wide = tsp.sparsify(img, bucket=64, min_capacity=k + 128)
    ref = jsp.sparsify(img, capacity=k + 128)
    _same_bits(wide["indices"], ref["indices"])
    _same_bits(wide["values"], ref["values"])
    assert tsp.sparsify(img, bucket=64, min_capacity=64)[
        "indices"].shape[1] == k


@pytest.mark.parametrize("case", EDGE_CASES)
def test_sparsify_batch_edge_cases_match_jax(case):
    """The training transfer (``_coo_rows`` for image, label and the
    weight residual) equal to the JAX package's, array for array."""
    img, _ = _edge_images(case)
    rng = np.random.RandomState(5)
    label = (img > 0).astype(np.int32) + 2 * (img < 0).astype(np.int32)
    weight = np.where(img != 0, rng.uniform(0.5, 4.0, img.shape),
                      1.0).astype(np.float32)
    batch = {"image": img[..., None], "label": label, "weight": weight}
    a = tsp.sparsify_batch(batch, bucket=64)
    b = jsp.sparsify_batch(batch, bucket=64)
    assert sorted(a) == sorted(b)
    for key in a:
        if key == "hw":
            assert a[key] == b[key]
        else:
            _same_bits(a[key], b[key])


@pytest.mark.parametrize("case", EDGE_CASES)
def test_mask_indices_edge_cases_match_jax(case):
    """The sparse readback's pixel list: the -1 sentinel, the cut at an
    external capacity (each row's first pixels) and ``min_capacity``'s
    extra -1 columns."""
    mask = _edge_images(case)[0] != 0
    cap = _edge_images(case)[1]
    for kw in ({"bucket": 64}, {"capacity": cap}):
        _same_bits(tsp.mask_indices(mask, **kw), jsp.mask_indices(mask, **kw))
    k = jsp.mask_indices(mask, bucket=64).shape[1]
    _same_bits(tsp.mask_indices(mask, bucket=64, min_capacity=k + 64),
               jsp.mask_indices(mask, capacity=k + 64))
