"""Sparse readback of the port's precropped runner
(``compact_readback="sparse"``, ``--compact-readback sparse``): the
halo (ops/sparse.py:dilate_mask), the gather forward, the -1 pad
sentinel and the host paste over the zero-input field, against the JAX
package's on the same images and reference .tar.

Inside the halo the scores are u8 fixed point: within 6e-3 of the JAX
CLI's. Outside it both packages fill the network's zero-input response.
A pad slot never reaches pixel (0, 0), also when a later batch's halo
is smaller than the capacity an earlier one set (the JAX package's
tests/test_tiling_deploy_capgrow.py case).

The weights are random_state_dict(seed=2) with the classifier scaled
by 3e-4: unscaled, random BatchNorm statistics blow the logits up to
≈ 6e3 and every float32 probability is exactly 0 or 1, where a pad slot
pasting pixel 0's own score over the zero-input field would change
nothing and the sentinel would go untested."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ubresnet_tpu.cli.infer_precropped import main as jax_main
from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.data.uevt import EventFileReader as JaxReader
from ubresnet_tpu.deploy.importers import load_reference_model
from ubresnet_tpu.ops import sparse as jsp
from ubresnet_tpu_torch.cli.infer_precropped import main as port_main
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader as PortReader
from ubresnet_tpu_torch.data.uevt import EventFileWriter
from ubresnet_tpu_torch.deploy import PrecroppedRunner
from ubresnet_tpu_torch.deploy.weights import (
    load_reference_checkpoint,
    random_state_dict,
    save_reference_checkpoint,
)
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.ops import sparse as tsp

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore:compact_readback='sparse'")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sparse_readback")
    data = make_synthetic_file(str(d / "in.uevt"), n_events=4, hw=(64, 64),
                               seed=5)
    sd = random_state_dict(seed=2)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-4
    return d, data, save_reference_checkpoint(sd, str(d / "ref.tar"))


@pytest.fixture(scope="module")
def model(files):
    sd, _ = load_reference_checkpoint(files[2])
    return get_model("uresnet", sd, policy=Policy.f32(), device="cpu")


@pytest.mark.parametrize("r", [0, 1, 3, 40])
def test_dilate_mask_equals_jax_and_never_aliases(r):
    rng = np.random.RandomState(r)
    mask = rng.rand(3, 24, 40) > 0.97
    mask[0, 0, 0] = mask[1, -1, -1] = True
    before = mask.copy()
    got = tsp.dilate_mask(mask, r)
    np.testing.assert_array_equal(got, jsp.dilate_mask(mask, r))
    np.testing.assert_array_equal(mask, before)
    assert not np.shares_memory(got, mask)
    got[:] = ~got  # the caller may write to it
    np.testing.assert_array_equal(mask, before)
    if r == 1:  # one charge → a 3x3 square, clipped at the edges
        one = np.zeros((1, 5, 5), bool)
        one[0, 2, 2] = True
        assert tsp.dilate_mask(one, 1)[0].sum() == 9


def test_gather_forward_matches_jax(files, model):
    """The gather forward's u8 scores at the halo pixels equal JAX's
    sparse_gather_forward_fn's on the same batch and weights, within one
    u8 step; -1 slots read pixel 0 (the host drops them)."""
    rng = np.random.RandomState(0)
    img = (rng.rand(2, 64, 64) * 50).astype(np.float32)
    img[rng.rand(2, 64, 64) > 0.03] = 0.0
    sp = tsp.sparsify(img, bucket=256)
    out_idx = tsp.mask_indices(tsp.dilate_mask(img != 0, 2), bucket=256)
    assert (out_idx == -1).any()
    with torch.inference_mode():
        got = tsp.sparse_gather_forward(
            model, torch.from_numpy(sp["indices"]),
            torch.from_numpy(sp["values"]), torch.from_numpy(out_idx),
            (64, 64)).numpy()
    jm, jv = load_reference_model(files[2], policy=JaxPolicy.f32())
    want = np.asarray(jsp.sparse_gather_forward_fn(jm)(
        jv, jnp.asarray(sp["indices"]), jnp.asarray(sp["values"]),
        jnp.asarray(out_idx), (64, 64)))
    assert got.dtype == np.uint8 and got.shape == want.shape == (
        2, out_idx.shape[1], 2)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    for b in range(2):  # every sentinel of a row reads that row's pixel 0
        pad = got[b][out_idx[b] < 0]
        np.testing.assert_array_equal(pad, np.broadcast_to(pad[:1],
                                                           pad.shape))


def _scores(reader, i):
    return np.stack([im.pixels.astype(np.float32)
                     for im in reader.read_entry(i)["uburn_plane2"]], -1)


def test_port_sparse_readback_matches_jax_cli(files):
    d, data, ckpt = files
    common = ["-i", data, "-c", ckpt, "-b", "3", "--f32",
              "--compact-readback", "sparse", "--readback-dilate", "3"]
    out_jax, out_port, out_full = (str(d / f) for f in
                                   ("jax.uevt", "port.uevt", "full.uevt"))
    assert jax_main(common + ["-o", out_jax]) == 0
    with pytest.warns(UserWarning, match="zero-input response"):
        assert port_main(common + ["-o", out_port, "--device", "cpu"]) == 0
    assert port_main(["-i", data, "-c", ckpt, "-b", "3", "--f32", "-o",
                      out_full, "--device", "cpu"]) == 0
    a, b, full = PortReader(out_jax), JaxReader(out_port), PortReader(
        out_full)
    src = PortReader(data)
    assert len(a) == len(b) == 4
    for i in range(4):
        adc = src.read_entry(i)["wire"][0].pixels
        halo = tsp.dilate_mask((adc != 0)[None], 3)[0]
        assert halo.any() and not halo.all()
        sj, sp, sf = _scores(a, i), _scores(b, i), _scores(full, i)
        np.testing.assert_allclose(sp.sum(-1), 1.0, atol=6e-3)
        # inside the halo: the u8 scores of the full forward
        np.testing.assert_allclose(sp[halo], sj[halo], atol=6e-3)
        np.testing.assert_allclose(sp[halo], sf[halo], atol=6e-3)
        # outside: both packages' zero-input fields
        np.testing.assert_allclose(sp[~halo], sj[~halo], atol=1e-4)


def test_sparse_readback_requires_sparse_transfer(model):
    with pytest.raises(ValueError, match="requires sparse"):
        PrecroppedRunner(model, compact_readback="sparse", sparse=False)
    with pytest.raises(ValueError, match="supports"):
        PrecroppedRunner(model, compact_readback="sparse8")


def test_dense_transfer_matches_sparse(files, model):
    """The same crops shipped dense or as COO give the same scores (the
    CPU's conv may sum in another order for another input buffer)."""
    d, data, _ = files
    outs = []
    for sparse in (True, False):
        out = str(d / f"transfer_{sparse}.uevt")
        PrecroppedRunner(model, batch_size=3, sparse=sparse).run(data, out)
        outs.append(PortReader(out))
    for i in range(4):
        np.testing.assert_allclose(_scores(outs[0], i), _scores(outs[1], i),
                                   rtol=0, atol=1e-5)


def _charged_events(path, charges, hw=64, seed=7):
    """One plane-2 image per event with exactly ``n`` charged pixels,
    kept ≥ 8 px from the border so a r=2 halo never reaches pixel
    (0, 0); descending counts make a later batch's halo smaller than
    the capacity the first one set."""
    rng = np.random.RandomState(seed)
    meta = ImageMeta(0.0, 0.0, hw * 0.5, hw * 0.5, hw, hw, 2)
    with EventFileWriter(path) as w:
        for e, n in enumerate(charges):
            px = np.zeros((hw, hw), np.float32)
            ys = rng.randint(8, hw - 8, size=n)
            xs = rng.randint(8, hw - 8, size=n)
            px[ys, xs] = rng.uniform(20.0, 80.0, size=n).astype(np.float32)
            w.append("wire", Image2D(px, meta))
            w.set_id(1, 0, e)
            w.save_entry()


def test_sparse_readback_survives_capacity_shrink(tmp_path, model,
                                                  monkeypatch):
    """A 64-pixel capacity grain (the runner's is 4096, a whole 64x64
    crop) so the second batch's halo really is padded up to the first
    one's capacity."""
    from ubresnet_tpu_torch.deploy import precropped

    monkeypatch.setattr(precropped, "SPARSE_BUCKET", 64)
    inp = str(tmp_path / "in.uevt")
    _charged_events(inp, [700, 650, 3, 2])
    runner = PrecroppedRunner(model, batch_size=2, compact_readback="sparse",
                              readback_dilate=2)
    out = str(tmp_path / "out.uevt")
    runner.run(inp, out)
    small = tsp.dilate_mask(PortReader(inp).read_entry(3)["wire"][0].pixels[
        None] != 0, 2).sum()
    assert runner._out_cap > tsp.round_capacity(int(small), 64)
    with torch.inference_mode():
        bg = torch.exp(model(torch.zeros(1, 64, 64, 1)))[0].numpy()
    ri, rs = PortReader(inp), PortReader(out)
    for e in range(4):
        adc = ri.read_entry(e)["wire"][0].pixels
        halo = tsp.dilate_mask((adc != 0)[None], 2)[0]
        assert not halo[0, 0]
        s = _scores(rs, e)
        # pixel (0, 0) and every pixel outside the halo carry the exact
        # zero-input field
        np.testing.assert_allclose(s[~halo], bg[~halo], atol=1e-6)
        np.testing.assert_allclose(s[0, 0], bg[0, 0], atol=1e-6)


def test_host_paste_drops_pad_slots(model):
    """_fetch_sparse: slots < 0 carry garbage and are dropped; real
    slots land at their pixels."""
    runner = PrecroppedRunner(model, batch_size=2, compact_readback="sparse")
    bg = runner._bg_field((8, 8))
    idx = np.array([[5, -1, -1], [0, 63, -1]], np.int32)
    g = np.full((2, 3, 2), 255, np.uint8)  # garbage in the pad slots too
    g[:, :, 1] = 0
    out = runner._fetch_sparse(g, idx, (8, 8))
    assert out.shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(out[0, 0, 0], bg[0, 0])
    np.testing.assert_allclose(out[0, 0, 5], [1.0, 0.0, 0.0])
    np.testing.assert_allclose(out[1, 0, 0], [1.0, 0.0, 0.0])
    np.testing.assert_allclose(out[1, 7, 7], [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(out[1, 3, 3], bg[3, 3])
