"""The port's training loader (ubresnet_tpu_torch/data/loader.py) against
the JAX package's (ubresnet_tpu/data/loader.py) on the same synthetic
.uevt: SegmentDataset samples (label_offset, class_map, threshold, the
rse key), BatchLoader batches with one thread and one seed (with_rse),
DevicePrefetcher's depth and drop_keys, and larcv .root inputs, which
both loaders read through a one-time cached .uevt conversion."""
import numpy as np
import pytest
import torch

from ubresnet_tpu.data.loader import BatchLoader as JaxBatchLoader
from ubresnet_tpu.data.loader import SegmentDataset as JaxSegmentDataset
from ubresnet_tpu_torch.data import loader
from ubresnet_tpu_torch.data.rootio import uevt_to_root
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    d = tmp_path_factory.mktemp("loader")
    return d, make_synthetic_file(str(d / "ev.uevt"), n_events=6,
                                  hw=(32, 48), seed=8)


DATASETS = [dict(), dict(label_offset=1, class_map=[0, 0, 1, 2]),
            dict(plane=2, adc_threshold=15.0, weight_producer=None)]


@pytest.mark.parametrize("kw", DATASETS, ids=["plain", "offset-remap",
                                              "threshold"])
def test_dataset_samples_equal_jax(synth, kw):
    _, path = synth
    port, jax = loader.SegmentDataset(path, **kw), JaxSegmentDataset(path,
                                                                     **kw)
    assert len(port) == len(jax) == 6
    for i in range(6):
        got, want = port.get(i), jax.get(i)
        assert got.keys() == want.keys() == {"image", "label", "weight",
                                             "rse"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("with_rse", [False, True])
def test_batch_loader_equals_jax(synth, with_rse):
    _, path = synth
    batches = {}
    for name, ds_cls, bl_cls in (
            ("port", loader.SegmentDataset, loader.BatchLoader),
            ("jax", JaxSegmentDataset, JaxBatchLoader)):
        bl = bl_cls(ds_cls(path), batch_size=3, n_threads=1, seed=4,
                    with_rse=with_rse).start()
        try:
            batches[name] = [bl[0] for _ in range(3)] + [bl.getbatch(5)]
        finally:
            bl.stop()
    for got, want in zip(batches["port"], batches["jax"]):
        assert got.keys() == want.keys()
        assert ("rse" in got) == with_rse
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    assert batches["port"][-1]["image"].shape == (5, 32, 48, 1)


@pytest.mark.parametrize("depth,drop_keys", [(2, ("rse",)), (1, ())])
def test_prefetcher_depth_and_drop_keys(synth, depth, drop_keys):
    _, path = synth
    bl = loader.BatchLoader(loader.SegmentDataset(path), batch_size=2,
                            n_threads=1, with_rse=True).start()
    try:
        pf = loader.DevicePrefetcher(bl, torch.device("cpu"), depth=depth,
                                     drop_keys=drop_keys)
        assert pf.depth == depth
        batch = next(iter(pf))
    finally:
        bl.stop()
    assert ("rse" in batch) == (not drop_keys)
    assert batch["image"].shape == (2, 32, 48, 1)
    assert all(isinstance(v, torch.Tensor) for v in batch.values())


def test_root_training_files_read_through_the_cache(synth, monkeypatch,
                                                    capsys):
    d, path = synth
    monkeypatch.setattr(loader, "root_cache_dir",
                        lambda: str(d / "cache"))
    root = str(d / "ev.root")
    uevt_to_root(path, root)
    cached = loader.training_paths([root, path])
    assert cached[1] == path and cached[0].startswith(str(d / "cache"))
    assert "converted" in capsys.readouterr().out
    assert loader.training_paths([root]) == cached[:1]  # reused
    assert "converted" not in capsys.readouterr().out
    a, b = loader.SegmentDataset(root), loader.SegmentDataset(path)
    for i in range(len(b)):
        for k, v in b.get(i).items():
            np.testing.assert_array_equal(a.get(i)[k], v)
