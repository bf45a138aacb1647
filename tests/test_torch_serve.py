"""The port's watch-dir serving CLI (ubresnet_tpu_torch.cli.serve,
--device cpu) against the JAX package's (ubresnet_tpu.cli.serve) on
copies of the same watch dir and the same reference .tar: drain-once
semantics, one warm model across files, the .failed quarantine,
idempotent re-runs, int8 calibrated on the first served file
(precropped and wholeview), a continuous loop that stops on SIGTERM,
and the larcv .root paths that are not ported yet.

Scores are compared at the bars of the CLI tests: float32 serve against
JAX's float32 serve with argmax agreement >= 99.9% and max|Δp| <= 1e-3;
int8 serve within mean|Δp| < 0.02 and argmax > 0.95 of JAX's int8 serve
and of the port's own float32 serve (tests/test_torch_int8_cli.py). The
flags that shape int8 and wholeview scoring (--int8-calib,
--int8-percentile, --planes, the tile flags, --f16-scores) are held
bit for bit against a runner built and calibrated by hand.

The weights are random_state_dict(seed=2) with the classifier scaled
by 3e-4, as in tests/test_torch_wholeview.py: unscaled, random
BatchNorm statistics saturate every probability to exactly 0 or 1."""
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ubresnet_tpu.cli.serve import main as jax_main
from ubresnet_tpu_torch.cli.serve import main
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader, EventFileWriter
from ubresnet_tpu_torch.deploy import PrecroppedRunner, WholeViewRunner
from ubresnet_tpu_torch.deploy.weights import (
    load_reference_checkpoint,
    random_state_dict,
    save_reference_checkpoint,
)
from ubresnet_tpu_torch.models import get_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE_KW = dict(tile_rows=64, tile_cols=64, min_overlap_rows=8,
               min_overlap_cols=8, crop_batch=4)
WHOLEVIEW = ["--wholeview", "--planes", "2", "--tile-rows", "64",
             "--tile-cols", "64", "--overlap-rows", "8", "--overlap-cols",
             "8", "--crop-batch", "4"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_ckpt")
    sd = random_state_dict(seed=2)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-4
    return save_reference_checkpoint(sd, str(d / "ref.tar"))


def _lines(text):
    return [json.loads(line) for line in text.strip().splitlines()
            if line.startswith("{")]


def _scores(path, producer="uburn_plane2"):
    """(entries, h, w, 3) float32 scores of ``producer`` in ``path``."""
    r = EventFileReader(path)
    return np.stack([np.stack([im.pixels.astype(np.float32)
                               for im in r.read_entry(i)[producer]], -1)
                     for i in range(len(r))])


def _sums(path, n, producer="uburn_plane2", atol=1e-4, hw=(64, 64)):
    s = _scores(path, producer)
    assert s.shape == (n,) + hw + (3,)
    np.testing.assert_allclose(s.sum(-1), 1.0, atol=atol)


def _jax_serve(tmp_path, tag, watch, names, argv):
    """JAX's serve --once on a copy of ``names`` from ``watch``; the
    signal handlers it installs are put back."""
    jwatch, jout = tmp_path / f"jax_{tag}_in", tmp_path / f"jax_{tag}_out"
    jwatch.mkdir()
    for name in names:
        shutil.copy(watch / name, jwatch / name)
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                              signal.SIGINT)}
    try:
        assert jax_main(["--watch-dir", str(jwatch), "--out-dir",
                         str(jout), "--once", *argv]) == 0
    finally:
        for s, handler in saved.items():
            signal.signal(s, handler)
    return jout


def _assert_f32_close(port, ref):
    assert port.shape == ref.shape
    assert (port.argmax(-1) == ref.argmax(-1)).mean() >= 0.999
    assert np.abs(port - ref).max() <= 1e-3


def _assert_int8_close(q, ref):
    assert q.shape == ref.shape and np.isfinite(q).all()
    assert np.abs(q - ref).mean() < 0.02
    assert (q.argmax(-1) == ref.argmax(-1)).mean() > 0.95


def _int8_model(ckpt):
    sd, _ = load_reference_checkpoint(ckpt)
    return get_model("uresnet", sd, policy=Policy.int8(), device="cpu")


def test_serve_once_drains_and_quarantines(tmp_path, ckpt, capsys):
    watch, out = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    make_synthetic_file(str(watch / "a.uevt"), n_events=3, hw=(64, 64))
    make_synthetic_file(str(watch / "b.uevt"), n_events=1, hw=(64, 64),
                        seed=1)
    (watch / "broken.uevt").write_bytes(b"not an event file")
    (watch / "r.root").write_bytes(b"root")
    (watch / "notes.txt").write_text("ignored")
    argv = ["--watch-dir", str(watch), "--out-dir", str(out), "-c", ckpt,
            "-p", "2", "--once", "-b", "2", "--f32", "--device", "cpu"]
    handlers = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    assert main(argv) == 0
    # an in-process caller gets its signal handlers back
    assert [signal.getsignal(s) for s in (signal.SIGTERM,
                                          signal.SIGINT)] == handlers
    captured = capsys.readouterr()
    lines = _lines(captured.out)
    assert lines[-1] == {"shutdown": True, "served": 2}
    assert [ln["served"] for ln in lines[:-1]] == ["a.uevt", "b.uevt"]
    assert lines[0]["output"] == "a_scores.uevt"
    assert set(lines[0]["timing"]) == {"total", "read", "forward", "write"}
    _sums(str(out / "a_scores.uevt"), 3)
    _sums(str(out / "b_scores.uevt"), 1)
    assert (out / "broken.uevt.failed").exists()
    assert not (out / "broken_scores.uevt").exists()  # partial removed
    marker = (out / "r.root.failed").read_text()
    assert "items 3 and 5" in marker and "NotImplementedError" in marker
    failed = _lines(captured.err)
    assert {f["failed"] for f in failed} == {"broken.uevt", "r.root"}

    # the same files through the JAX package's serve loop
    jout = _jax_serve(tmp_path, "f32", watch, ["a.uevt", "b.uevt"],
                      ["-c", ckpt, "-p", "2", "-b", "2", "--f32"])
    capsys.readouterr()
    for name in ("a", "b"):
        _assert_f32_close(_scores(str(out / f"{name}_scores.uevt")),
                          _scores(str(jout / f"{name}_scores.uevt")))

    # idempotent: nothing new on a second drain
    assert main(argv) == 0
    assert _lines(capsys.readouterr().out)[-1]["served"] == 0


def test_serve_once_int8(tmp_path, ckpt, capsys):
    """int8 serve calibrates once, on the first served file, with
    --int8-calib and --int8-percentile: its scores equal a runner
    calibrated by hand on that file with that statistic, differ from
    one calibrated on the other file, and (abs-max scales) track JAX's
    int8 serve and the port's float32 serve. Percentile scales saturate
    the largest activations and move both packages' int8 further from
    their float32, so the float32 bar is held with abs-max scales."""
    watch, out = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    make_synthetic_file(str(watch / "a.uevt"), n_events=2, hw=(64, 64))
    make_synthetic_file(str(watch / "b.uevt"), n_events=2, hw=(64, 64),
                        seed=1)
    q = ["-c", ckpt, "-b", "2", "--int8", "--int8-calib", "2"]
    assert main(["--watch-dir", str(watch), "--out-dir", str(out), "--once",
                 "-v", *q, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    # calibrated once, on the first served file
    assert text.count("int8: calibrated on 2 images from a.uevt") == 1
    assert "calibrated" not in text.split("a_scores.uevt")[1]
    assert _lines(text)[-1] == {"shutdown": True, "served": 2}
    for name in ("a", "b"):
        _sums(str(out / f"{name}_scores.uevt"), 2, atol=1e-2)
    pout = tmp_path / "p999"
    assert main(["--watch-dir", str(watch), "--out-dir", str(pout),
                 "--once", *q, "--int8-percentile", "99.9",
                 "--device", "cpu"]) == 0

    for served, calib, pct, same in ((out, "a", None, True),
                                     (out, "b", None, False),
                                     (pout, "a", 99.9, True),
                                     (pout, "a", None, False)):
        runner = PrecroppedRunner(_int8_model(ckpt), batch_size=2)
        runner.calibrate_from(str(watch / f"{calib}.uevt"), n_images=2,
                              percentile=pct)
        hand = str(tmp_path / "hand.uevt")
        runner.run(str(watch / "b.uevt"), hand)
        assert np.array_equal(_scores(hand), _scores(
            str(served / "b_scores.uevt"))) == same, (served, calib, pct)

    fout = tmp_path / "f32"
    assert main(["--watch-dir", str(watch), "--out-dir", str(fout),
                 "--once", "-c", ckpt, "-b", "2", "--f32",
                 "--device", "cpu"]) == 0
    jout = _jax_serve(tmp_path, "int8", watch, ["a.uevt", "b.uevt"], q)
    capsys.readouterr()
    for name in ("a", "b"):
        s = _scores(str(out / f"{name}_scores.uevt"))
        _assert_int8_close(s, _scores(str(jout / f"{name}_scores.uevt")))
        _assert_int8_close(s, _scores(str(fout / f"{name}_scores.uevt")))


def _two_plane_file(path, n_events=2, hw=(128, 192)):
    """Whole views of planes 1 and 2 in each entry, charge above the
    10-ADC occupancy threshold in some tiles of each."""
    rng = np.random.RandomState(11)
    with EventFileWriter(path) as w:
        for i in range(n_events):
            for plane in (1, 2):
                img = (rng.rand(*hw) * 60).astype(np.float32)
                img[rng.rand(*hw) > 0.05] = 0.0
                meta = ImageMeta(0.0, 0.0, float(hw[1]), float(hw[0]),
                                 hw[0], hw[1], plane)
                w.append("wire", Image2D(img, meta, 1, 0, i))
            w.set_id(1, 0, i)
            w.save_entry()
    return path


def test_serve_once_wholeview_int8(tmp_path, ckpt, capsys):
    """--wholeview --planes 2 with the tile flags, int8 calibrated on
    the first file's plane-2 tiles with the percentile, float16 scores:
    only plane 2 is scored, its scores equal a hand-built runner's, and
    they track JAX's serve and the port's float32 serve."""
    watch, out = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    _two_plane_file(str(watch / "wv.uevt"))
    q = ["-c", ckpt, *WHOLEVIEW, "--int8", "--int8-calib", "2",
         "--int8-percentile", "99.9", "--f16-scores"]
    assert main(["--watch-dir", str(watch), "--out-dir", str(out), "--once",
                 "-v", *q, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "int8: calibrated on" in text and "tiles from wv.uevt" in text
    lines = _lines(text)
    assert lines[-1] == {"shutdown": True, "served": 1}
    assert set(lines[0]["timing"]) == {"total", "read", "splitscore",
                                       "write"}
    got = str(out / "wv_scores.uevt")
    assert sorted(EventFileReader(got).read_entry(0)) == ["ubsnet_plane2"]
    _sums(got, 2, producer="ubsnet_plane2", atol=1e-2, hw=(128, 192))
    img = EventFileReader(got).read_entry(0)["ubsnet_plane2"][0]
    assert img.pixels.dtype == np.float16

    runner = WholeViewRunner(_int8_model(ckpt), score_dtype=np.float16,
                             **TILE_KW)
    n_tiles = runner.calibrate_from(str(watch / "wv.uevt"), planes=[2],
                                    n_images=2, percentile=99.9)
    assert f"calibrated on {n_tiles} tiles" in text
    hand = str(tmp_path / "hand.uevt")
    runner.run(str(watch / "wv.uevt"), hand, planes=[2])
    np.testing.assert_array_equal(_scores(hand, "ubsnet_plane2"),
                                  _scores(got, "ubsnet_plane2"))

    fout = tmp_path / "f32"
    f32 = ["-c", ckpt, *WHOLEVIEW, "--f32"]
    assert main(["--watch-dir", str(watch), "--out-dir", str(fout),
                 "--once", *f32, "--device", "cpu"]) == 0
    jq = _jax_serve(tmp_path, "int8", watch, ["wv.uevt"], q)
    jf = _jax_serve(tmp_path, "f32", watch, ["wv.uevt"], f32)
    capsys.readouterr()
    port_f = _scores(str(fout / "wv_scores.uevt"), "ubsnet_plane2")
    _assert_f32_close(port_f, _scores(str(jf / "wv_scores.uevt"),
                                      "ubsnet_plane2"))
    s = _scores(got, "ubsnet_plane2")
    _assert_int8_close(s, _scores(str(jq / "wv_scores.uevt"),
                                  "ubsnet_plane2"))
    _assert_int8_close(s, port_f)


def test_serve_refuses_root_out_and_mixed_precision(tmp_path, ckpt):
    base = ["--watch-dir", str(tmp_path), "--out-dir", str(tmp_path / "o"),
            "-c", ckpt, "--once", "--device", "cpu"]
    with pytest.raises(SystemExit, match="items 3 and 5"):
        main(base + ["--root-out"])
    with pytest.raises(SystemExit, match="exclusive"):
        main(base + ["--int8", "--f32"])
    with pytest.raises(SystemExit, match="item 11"):
        main(base + ["--config", "cfg.json"])
    assert not (tmp_path / "o").exists()


def _wait_for(path, proc, timeout):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.exists(path):
            return True
        if proc.poll() is not None:
            return False
        time.sleep(0.1)
    return False


def test_serve_loop_serves_new_files_and_stops_on_sigterm(tmp_path, ckpt):
    """The continuous loop in its own process: a file already there and
    one written while it runs are served after their size held for two
    polls; SIGTERM ends the loop with the shutdown line and exit 0. Every
    wait is bounded: the whole test stays under 60 s."""
    watch, out = tmp_path / "in", tmp_path / "out"
    watch.mkdir()
    make_synthetic_file(str(watch / "a.uevt"), n_events=2, hw=(64, 64))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ubresnet_tpu_torch.cli.serve",
         "--watch-dir", str(watch), "--out-dir", str(out), "-c", ckpt,
         "-b", "2", "--poll", "0.2", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    try:
        assert _wait_for(str(out / "a_scores.uevt"), proc, 25)
        make_synthetic_file(str(tmp_path / "c.uevt"), n_events=1,
                            hw=(64, 64))
        os.replace(tmp_path / "c.uevt", watch / "c.uevt")
        assert _wait_for(str(out / "c_scores.uevt"), proc, 15)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=15)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-2000:]
    lines = _lines(stdout)
    assert lines[-1] == {"shutdown": True, "served": 2}
    assert [ln["served"] for ln in lines[:-1]] == ["a.uevt", "c.uevt"]
    _sums(str(out / "c_scores.uevt"), 1)


def test_serve_defaults_to_cuda(monkeypatch, tmp_path, ckpt):
    """No --device: the serve loop asks for the card and raises without
    one; it never falls to the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--watch-dir", str(tmp_path), "--out-dir",
              str(tmp_path / "o"), "-c", ckpt, "--once"])
