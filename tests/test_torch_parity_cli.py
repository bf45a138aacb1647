"""The port's caffe inference CLI and the comparison and evaluation
stack (ubresnet_tpu_torch.cli.{infer_caffe,compare,evaluate},
parity/{align,compare,evaluate}) against the JAX package's on the same
files: infer_caffe's scores on one plane, compare and evaluate (their
functions and CLIs, ids out of order, PNG dumps), entry alignment and
its error."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from ubresnet_tpu.cli.compare import main as jax_compare_main
from ubresnet_tpu.cli.evaluate import main as jax_evaluate_main
from ubresnet_tpu.cli.infer_caffe import main as jax_infer_caffe
from ubresnet_tpu.data.uevt import EventFileReader as JaxReader
from ubresnet_tpu.parity import align as jax_align
from ubresnet_tpu.parity import compare as jax_compare
from ubresnet_tpu.parity import evaluate as jax_evaluate
from ubresnet_tpu_torch.cli.compare import main as port_compare_main
from ubresnet_tpu_torch.cli.evaluate import main as port_evaluate_main
from ubresnet_tpu_torch.cli.infer_caffe import main as port_infer_caffe
from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader, EventFileWriter
from ubresnet_tpu_torch.models.ssnet2018 import ssnet2018_prototxt
from ubresnet_tpu_torch.parity import align, compare, evaluate
from ubresnet_tpu_torch.parity.caffe import CaffeNet, write_caffemodel

torch.set_num_threads(1)

# infer_caffe's scores against JAX's: the tamed head's logits reach
# ≈ 45, where a logit's f32 difference (≈ 3e-6 of it,
# tests/test_torch_caffe.py) moves a probability by ≈ 2e-5 (measured
# 2.2e-5 on these inputs)
SCORE_TOL = 2e-4


def _score_file(path, order, seed, plane=2, hw=(32, 32), producer=None):
    """A score file: per entry (ids (1, 0, i) for i in ``order``) three
    softmax class images of ``producer`` (default ssnet_plane<plane>)."""
    rng = np.random.RandomState(seed)
    meta = ImageMeta(0.0, 0.0, float(hw[1]), float(hw[0]), hw[0], hw[1],
                     plane)
    with EventFileWriter(path) as out:
        for i in order:
            z = rng.randn(3, *hw).astype(np.float32) * 2
            p = np.exp(z) / np.exp(z).sum(0)
            for c in range(3):
                out.append(producer or f"ssnet_plane{plane}",
                           Image2D(p[c], meta, 1, 0, i))
            out.set_id(1, 0, i)
            out.save_entry()
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity")
    truth = make_synthetic_file(str(d / "truth.uevt"), n_events=4,
                                hw=(32, 32), seed=9)
    return {"dir": d, "truth": truth,
            "a": _score_file(str(d / "a.uevt"), range(4), 1),
            "b": _score_file(str(d / "b.uevt"), [2, 0, 3, 1], 2),
            "short": _score_file(str(d / "short.uevt"), [0, 1, 5], 3)}


def test_infer_caffe_scores_match_jax(tmp_path, capsys):
    """One plane through both CLIs with the same prototxt (ssnet2018 at
    inplanes 4) and caffemodel (seeded, the head tamed as golden_parity
    tames its surrogates): ssnet_plane2 float32 scores with the input's
    meta and ids, within SCORE_TOL of JAX's."""
    text = ssnet2018_prototxt(inplanes=4)
    proto = tmp_path / "net.prototxt"
    proto.write_text(text)
    params = CaffeNet(text, seed=11, device="cpu").params
    for name in ("conv10", "conv11"):
        params[name][0] = params[name][0] * np.float32(0.05)
    model = str(tmp_path / "plane2.caffemodel")
    write_caffemodel(model, params)
    src = make_synthetic_file(str(tmp_path / "in.uevt"), n_events=2,
                              hw=(64, 64), seed=4)
    outs = {}
    for tag, fn in (("port", port_infer_caffe), ("jax", jax_infer_caffe)):
        outs[tag] = str(tmp_path / f"{tag}.uevt")
        argv = ["-i", src, "-o", outs[tag], "--prototxt", str(proto),
                "-w", f"2:{model}", "-n", "2"]
        assert fn(argv + (["--device", "cpu"] if tag == "port" else [])) == 0
        timing = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert list(timing) == ["total", "read", "forward", "write"]
    port, want, inp = (EventFileReader(outs["port"]), JaxReader(outs["jax"]),
                       EventFileReader(src))
    assert len(port) == len(want) == 2
    for i in range(2):
        assert port.rse(i) == want.rse(i) == inp.rse(i)
        got = port.read_entry(i)["ssnet_plane2"]
        ref = want.read_entry(i)["ssnet_plane2"]
        assert len(got) == 3
        for g, r in zip(got, ref):
            assert g.pixels.dtype == np.float32
            assert dataclasses.asdict(g.meta) == dataclasses.asdict(r.meta)
            assert g.rse == r.rse == inp.rse(i)
            np.testing.assert_allclose(g.pixels, r.pixels, rtol=0,
                                       atol=SCORE_TOL)
        s = np.stack([g.pixels for g in got])
        np.testing.assert_allclose(s.sum(0), 1.0, atol=1e-5)
        assert (s.max(0) < 0.99).any()  # not every pixel saturated


def test_infer_caffe_needs_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_infer_caffe(["-i", "in.uevt", "-o", str(tmp_path / "o.uevt")])


@pytest.mark.parametrize("pair", ["a-b", "b-a", "a-a", "a-short"])
def test_compare_matches_jax(files, pair, tmp_path):
    """compare_score_files by event id (file B out of order), with and
    without an ADC file, and the first n entries; an id without a
    partner raises JAX's error; the PNG dumps are the same bytes."""
    a, b = (files[k] for k in pair.split("-"))
    kw = dict(adc_file=files["truth"], n_entries=None)
    if pair == "a-short":
        with pytest.raises(ValueError) as got:
            compare.compare_score_files(a, b, "ssnet_plane2",
                                        "ssnet_plane2", **kw)
        with pytest.raises(ValueError) as want:
            jax_compare.compare_score_files(a, b, "ssnet_plane2",
                                            "ssnet_plane2", **kw)
        assert str(got.value) == str(want.value)
        assert "alignment failed" in str(got.value)
        return
    for extra in ({}, {"adc_file": None}, {"n_entries": 2,
                                           "adc_threshold": 20.0}):
        args = (a, b, "ssnet_plane2", "ssnet_plane2")
        assert compare.compare_score_files(*args, **{**kw, **extra}) == \
            jax_compare.compare_score_files(*args, **{**kw, **extra})
    dumps = {}
    for tag, mod in (("port", compare), ("jax", jax_compare)):
        dumps[tag] = tmp_path / tag
        mod.compare_score_files(a, b, "ssnet_plane2", "ssnet_plane2",
                                adc_file=files["truth"], n_entries=2,
                                dump_dir=str(dumps[tag]))
    names = sorted(p.name for p in dumps["jax"].iterdir())
    assert names and sorted(p.name for p in dumps["port"].iterdir()) == names
    for n in names:
        assert (dumps["port"] / n).read_bytes() == (dumps["jax"] / n
                                                    ).read_bytes()


@pytest.mark.parametrize("case", ["plain", "plane", "ignore", "no_adc"])
def test_evaluate_matches_jax(files, case):
    kw = {"plain": {}, "plane": {"plane": 2, "n_entries": 3},
          "ignore": {"ignore_label": 0, "adc_threshold": 5.0},
          "no_adc": {"adc_producer": None}}[case]
    for score in (files["a"], files["b"]):
        got = evaluate.evaluate_files(score, files["truth"], "ssnet_plane2",
                                      **kw)
        assert got == jax_evaluate.evaluate_files(score, files["truth"],
                                                  "ssnet_plane2", **kw)
        assert got["n_pixels"] > 0


def test_align_matches_jax(files, tmp_path):
    """Pairs by id in file-A order, the first n of file A, positional
    pairing when ids are degenerate or repeated, and the error naming
    the unmatched ids."""
    same = _score_file(str(tmp_path / "same.uevt"), [0, 0, 0], 4)
    dup = _score_file(str(tmp_path / "dup.uevt"), [1, 1, 2, 3], 5)
    for x, y, n in (("a", "b", None), ("b", "a", 2), ("a", "truth", 3)):
        got = align.align_entries(EventFileReader(files[x]),
                                  EventFileReader(files[y]), n)
        assert got == jax_align.align_entries(JaxReader(files[x]),
                                              JaxReader(files[y]), n)
    for other in (same, dup):
        got = align.align_entries(EventFileReader(files["a"]),
                                  EventFileReader(other))
        assert got == jax_align.align_entries(JaxReader(files["a"]),
                                              JaxReader(other))
        assert got == [(i, i) for i in range(len(got))]
    with pytest.raises(ValueError) as got:
        align.align_entries(EventFileReader(files["short"]),
                            EventFileReader(files["a"]))
    with pytest.raises(ValueError) as want:
        jax_align.align_entries(JaxReader(files["short"]),
                                JaxReader(files["a"]))
    assert str(got.value) == str(want.value) and "(1, 0, 5)" in str(got.value)


@pytest.mark.parametrize("cli", ["compare", "evaluate"])
def test_cli_prints_what_jax_prints(files, cli, capsys):
    if cli == "compare":
        argv = [files["a"], files["b"], "--producer-a", "ssnet_plane2",
                "--producer-b", "ssnet_plane2", "--adc-file", files["truth"],
                "-n", "3"]
        mains = (port_compare_main, jax_compare_main)
    else:
        argv = [files["b"], files["truth"], "--score-producer",
                "ssnet_plane2", "--plane", "2", "--ignore-label", "1"]
        mains = (port_evaluate_main, jax_evaluate_main)
    printed = []
    for fn in mains:
        assert fn(argv) == 0
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and json.loads(printed[0])
