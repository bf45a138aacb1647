"""The port's C++ reader and batch filler (ubresnet_tpu_torch/data/
native.py over its own copy of cpp/uevt.cpp) against the JAX package's
(ubresnet_tpu/data/native.py) on the same synthetic .uevt.

With one filler thread and one seed both draw from mt19937_64(seed), so
their batches must be equal; with a threshold, a class remap and
mirroring too. The trainer's make_loader serves a larcv .root config
through the port's filler, from the cached .uevt conversion."""
import numpy as np
import pytest
import torch

from ubresnet_tpu.data import native as jax_native
from ubresnet_tpu_torch.core.config import DataConfig
from ubresnet_tpu_torch.data import loader as port_loader
from ubresnet_tpu_torch.data import native
from ubresnet_tpu_torch.data.rootio import uevt_to_root
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader
from ubresnet_tpu_torch.train.trainer import make_loader

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "ev.uevt")
    return make_synthetic_file(path, n_events=10, hw=(64, 96), seed=5)


def test_reader_matches_jax_and_python(synth):
    py = EventFileReader(synth)
    nat, jnat = native.NativeEventFile(synth), jax_native.NativeEventFile(
        synth)
    assert len(nat) == len(jnat) == len(py) == 10
    for entry in (0, 3, 9):
        for prod in ("wire", "segment", "weight"):
            got = nat.read_image(entry, prod, plane=2)
            want = jnat.read_image(entry, prod, plane=2)
            np.testing.assert_array_equal(got.pixels, want.pixels)
            np.testing.assert_array_equal(
                got.pixels, py.read_entry(entry)[prod][0].pixels)
            assert got.rse == want.rse == py.rse(entry)
            assert tuple(vars(got.meta).values()) == tuple(
                vars(want.meta).values())
    with pytest.raises(KeyError):
        nat.read_image(0, "nope")
    nat.close()
    jnat.close()


def _batches(mod, synth, n, **kw):
    loader = mod.NativeBatchLoader(synth, n_threads=1, **kw).start()
    try:
        return [loader[0] for _ in range(n)]
    finally:
        loader.stop()


@pytest.mark.parametrize("kw", [
    dict(batch_size=3, plane=2, seed=1),
    dict(batch_size=2, plane=2, seed=2, adc_threshold=20.0,
         class_map=[0, 2, 1], mirror=True),
    dict(batch_size=4, plane=-1, seed=7, weight_producer=None),
], ids=["plain", "threshold-remap-mirror", "no-weight"])
def test_filler_batches_equal_jax(synth, kw):
    got, want = _batches(native, synth, 4, **kw), _batches(jax_native,
                                                           synth, 4, **kw)
    b = kw["batch_size"]
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"image", "label", "weight"}
        assert g["image"].shape == (b, 64, 96, 1)
        assert g["label"].dtype == np.int32
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    if "adc_threshold" in kw:
        nz = got[0]["image"][got[0]["image"] != 0]
        assert nz.size and nz.min() >= 20.0
    # different draws across batches: the stream advances
    assert not np.array_equal(got[0]["image"], got[1]["image"])


def test_getbatch_matches_jax(synth):
    kw = dict(batch_size=3, plane=2, n_threads=1, seed=4)
    port = native.NativeBatchLoader(synth, **kw).start()
    jax = jax_native.NativeBatchLoader(synth, **kw).start()
    try:
        for bs in (None, 2, 5):
            g, w = port.getbatch(bs), jax.getbatch(bs)
            assert g["image"].shape == (bs or 3, 64, 96, 1)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
        with pytest.raises(ValueError):
            port.getbatch(-1)
    finally:
        port.stop()
        jax.stop()


def test_make_loader_serves_root_natively_through_the_cache(
        tmp_path, synth, monkeypatch, capsys):
    monkeypatch.setattr(port_loader, "root_cache_dir",
                        lambda: str(tmp_path / "cache"))
    root = str(tmp_path / "t.root")
    assert uevt_to_root(synth, root) == 10
    cfg = DataConfig(files=[root], batch_size=3, plane=2, n_threads=1,
                     weight_producer="weight")
    loader = make_loader(cfg, seed=3)
    assert type(loader).__name__ == "NativeBatchLoader"
    assert loader.n_entries == 10
    assert "converted" in capsys.readouterr().out
    cached = list((tmp_path / "cache").glob("*.uevt"))
    assert len(cached) == 1
    loader.start()
    try:
        b = loader[0]
    finally:
        loader.stop()
    # the cache holds the same events, so the filler draws the .uevt's
    want = _batches(native, synth, 1, batch_size=3, plane=2, seed=3)[0]
    for k in b:
        np.testing.assert_array_equal(b[k], want[k])
    # a second loader reuses the cached file without converting again
    make_loader(cfg, seed=3)
    assert "converted" not in capsys.readouterr().out
