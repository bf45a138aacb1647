"""larcv .root in and out through the port's three deploy entry points
(infer_precropped, infer_wholeview, serve --root-out), --device cpu
--f32, against the JAX package's CLIs on the same .root input and the
same reference .tar.

Weights: the "tame" state_dict of tests/test_torch_wholeview.py
(random_state_dict(seed=2), classifier × 3e-4), whose float32
probabilities are informative rather than saturated. Tolerances: those
of the .uevt tests (tests/test_torch_wholeview.py, test_torch_serve.py):
argmax agreement ≥ 99.9%, max|Δp| ≤ 1e-3, class sums 1 within 1e-4;
meta and run/subrun/event equal. A .root output holds float32 scores
even under --f16-scores, and the port's .root scores are the same
numbers as its .uevt scores of the same run."""
import dataclasses
import shutil
import signal

import numpy as np
import pytest
import torch

from ubresnet_tpu.cli.infer_precropped import main as jax_precropped
from ubresnet_tpu.cli.infer_wholeview import main as jax_wholeview
from ubresnet_tpu.cli.serve import main as jax_serve
from ubresnet_tpu.data.rootio import RootEventReader as JaxRootReader
from ubresnet_tpu_torch.cli.infer_precropped import main as port_precropped
from ubresnet_tpu_torch.cli.infer_wholeview import main as port_wholeview
from ubresnet_tpu_torch.cli.serve import main as port_serve
from ubresnet_tpu_torch.data.rootio import RootEventReader, uevt_to_root
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader
from ubresnet_tpu_torch.deploy.weights import (
    random_state_dict,
    save_reference_checkpoint,
)

torch.set_num_threads(1)

TILES = ["--tile-rows", "64", "--tile-cols", "64", "--overlap-rows", "8",
         "--overlap-cols", "8", "--crop-batch", "4"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("root_deploy")
    sd = random_state_dict(seed=2)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-4
    ckpt = save_reference_checkpoint(sd, str(d / "tame.tar"))
    crops = make_synthetic_file(str(d / "crops.uevt"), n_events=4,
                                hw=(64, 64), seed=5)
    planes = make_synthetic_file(str(d / "planes.uevt"), n_events=2,
                                 hw=(128, 192), seed=5)
    for src in (crops, planes):
        uevt_to_root(src, src[:-5] + ".root")
    return d, ckpt


def _scores(reader, producer):
    """[(entries of (h, w, 3) scores, images)] of ``producer``."""
    out = []
    for i in range(len(reader)):
        imgs = reader.read_entry(i)[producer]
        out.append((np.stack([im.pixels for im in imgs], -1), imgs))
    return out


def _assert_close(port_path, jax_path, producer, src_path, n):
    port, jax = RootEventReader(port_path), JaxRootReader(jax_path)
    src = EventFileReader(src_path[:-5] + ".uevt")
    a, b = _scores(port, producer), _scores(jax, producer)
    assert len(a) == len(b) == n
    for i, ((sp, ip), (sj, ij)) in enumerate(zip(a, b)):
        assert sp.dtype == np.float32 and sj.dtype == np.float32
        assert ip[0].rse == ij[0].rse == src.rse(i)
        assert (dataclasses.astuple(ip[0].meta)
                == dataclasses.astuple(src.read_entry(i)["wire"][0].meta))
        np.testing.assert_allclose(sp.sum(-1), 1.0, atol=1e-4)
        assert (sp.argmax(-1) == sj.argmax(-1)).mean() >= 0.999
        assert np.abs(sp - sj).max() <= 1e-3
    return a


def test_precropped_root_to_root_matches_jax(files):
    d, ckpt = files
    src = str(d / "crops.root")
    out_p, out_j, out_u = (str(d / n) for n in ("p.root", "j.root",
                                                "p.uevt"))
    common = ["-i", src, "-c", ckpt, "-b", "3", "--f32"]
    assert port_precropped(common + ["-o", out_p, "--f16-scores",
                                     "--device", "cpu"]) == 0
    assert jax_precropped(common + ["-o", out_j]) == 0
    got = _assert_close(out_p, out_j, "uburn_plane2", src, 4)
    assert port_precropped(common + ["-o", out_u, "--device", "cpu"]) == 0
    uevt = EventFileReader(out_u)
    for i, (s, _) in enumerate(got):
        np.testing.assert_array_equal(s, np.stack(
            [im.pixels for im in uevt.read_entry(i)["uburn_plane2"]], -1))


@pytest.mark.parametrize("mode", [[], ["--stitched"]],
                         ids=["spatial", "stitched"])
def test_wholeview_root_to_root_matches_jax(files, mode):
    d, ckpt = files
    src = str(d / "planes.root")
    tag = "st" if mode else "sp"
    out_p, out_j = str(d / f"wp_{tag}.root"), str(d / f"wj_{tag}.root")
    common = ["-i", src, "-c", ckpt, "--f32", *TILES, *mode]
    assert port_wholeview(common + ["-o", out_p, "--f16-scores",
                                    "--device", "cpu"]) == 0
    assert jax_wholeview(common + ["-o", out_j]) == 0
    got = _assert_close(out_p, out_j, "ubsnet_plane2", src, 2)
    assert got[0][0].shape == (128, 192, 3)


def test_serve_root_out_matches_jax(files, tmp_path, capsys):
    """--root-out over a .root, a .uevt and a corrupt .root: both good
    files are served to <name>_scores.root, the corrupt one is
    quarantined with the reader's error, and each output matches JAX's
    serve loop on a copy of the directory."""
    d, ckpt = files
    watch = tmp_path / "in"
    watch.mkdir()
    shutil.copy(d / "crops.root", watch / "a.root")
    shutil.copy(d / "crops.uevt", watch / "b.uevt")
    (watch / "c.root").write_bytes(b"root" + b"\x00" * 60)
    argv = ["--once", "--root-out", "-c", ckpt, "-p", "2", "-b", "2",
            "--f32", "--f16-scores"]
    out = tmp_path / "out"
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                              signal.SIGINT)}
    assert port_serve(["--watch-dir", str(watch), "--out-dir", str(out),
                       *argv, "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "c.root" in err
    assert (out / "c.root.failed").read_text().startswith(
        "OSError: no image2d trees found")
    assert not (out / "c_scores.root").exists()
    jwatch, jout = tmp_path / "jin", tmp_path / "jout"
    jwatch.mkdir()
    for name in ("a.root", "b.uevt"):
        shutil.copy(watch / name, jwatch / name)
    try:
        assert jax_serve(["--watch-dir", str(jwatch), "--out-dir",
                          str(jout), *argv]) == 0
    finally:
        for s, handler in saved.items():
            signal.signal(s, handler)
    for name in ("a", "b"):
        _assert_close(str(out / f"{name}_scores.root"),
                      str(jout / f"{name}_scores.root"), "uburn_plane2",
                      str(d / "crops.root"), 4)
