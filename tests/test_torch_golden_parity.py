"""The port's golden-parity rig (ubresnet_tpu_torch.cli.golden_parity) on
the CPU, with the ssnet2018 graph at inplanes 4 (monkeypatched in the
test, not the code): its surrogate caffemodels byte-equal to the JAX
package's, the dry run's report (its numbers those of JAX's
compare_score_files on the port's files, the negative control
detected), and official mode against a tame UResNet .tar and a
checkpoint directory."""
import functools
import json
import os
import tempfile

import pytest
import torch

import ubresnet_tpu.models.ssnet2018 as jax_ssnet
import ubresnet_tpu_torch.models.ssnet2018 as port_ssnet
from ubresnet_tpu.cli.golden_parity import \
    make_surrogate_weights as jax_surrogates
from ubresnet_tpu.parity.compare import compare_score_files
from ubresnet_tpu_torch.cli import golden_parity
from ubresnet_tpu_torch.deploy.weights import (
    random_state_dict,
    save_reference_checkpoint,
)

torch.set_num_threads(1)


@pytest.fixture
def small_graph(monkeypatch, tmp_path):
    """Both packages' ssnet2018 generator at inplanes 4, and the rig's
    temporary files under tmp_path."""
    for mod in (jax_ssnet, port_ssnet):
        monkeypatch.setattr(mod, "ssnet2018_prototxt", functools.partial(
            mod.ssnet2018_prototxt, inplanes=4))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_surrogate_weights_equal_jax_byte_for_byte(small_graph):
    pdir, jdir = small_graph / "port", small_graph / "jax"
    pdir.mkdir()
    jdir.mkdir()
    got = golden_parity.make_surrogate_weights(str(pdir))
    want = jax_surrogates(str(jdir))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for plane in want:
        with open(got[plane], "rb") as f, open(want[plane], "rb") as g:
            assert f.read() == g.read()


def test_dry_run_report(small_graph, capsys):
    report_path = str(small_graph / "report.json")
    rc = golden_parity.main(["--dry-run", "--hw", "64", "-n", "1",
                             "--device", "cpu", "-o", report_path])
    assert rc == 0
    rep = json.loads(open(report_path).read())
    assert capsys.readouterr().out.endswith(json.dumps(rep, indent=2) + "\n")
    assert rep["ok"] is True and rep["mode"] == "dry-run"
    assert rep["threshold"] == 0.999 and set(rep["planes"]) == {"0", "1", "2"}
    tmp = os.path.dirname(rep["surrogate_weights"]["2"])
    files = {k: os.path.join(tmp, f"{k}.uevt")
             for k in ("events", "oracle", "reload", "negative")}
    for plane, m in rep["planes"].items():
        assert m["passes"] and m["label_agreement"] >= 0.999
        want = compare_score_files(
            files["oracle"], files["reload"], f"ssnet_plane{plane}",
            f"ssnet_plane{plane}", adc_file=files["events"])
        assert {k: v for k, v in m.items() if k != "passes"} == want
    neg = rep["negative_control"]
    assert neg["detected"] and neg["label_agreement"] < 0.999
    want = compare_score_files(files["oracle"], files["negative"],
                               "ssnet_plane2", "ssnet_plane2",
                               adc_file=files["events"])
    assert {k: v for k, v in neg.items() if k != "detected"} == want


@pytest.fixture
def tame_tar(tmp_path):
    """Seeded UResNet weights with the classifier scaled by 3e-5, so its
    scores are not saturated (tests/test_torch_aspp_cli.py's taming)."""
    sd = random_state_dict(seed=2)
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-5
    return sd, save_reference_checkpoint(sd, str(tmp_path / "tame.tar"))


def test_official_mode(small_graph, tame_tar, capsys):
    """Official mode: the caffe leg on three surrogate caffemodels, the
    port's infer_precropped per plane, on a .tar and on a checkpoint
    directory with --config (the same report); the exit code follows
    the report's ok, and every plane has pixels over threshold."""
    from ubresnet_tpu_torch.train.checkpoint import checkpoint_path

    d = small_graph
    wdir = d / "w"
    wdir.mkdir()
    weights = golden_parity.make_surrogate_weights(str(wdir))
    events = golden_parity.make_three_plane_file(str(d / "ev.uevt"), 2,
                                                 (64, 64), seed=3)
    base = ["-i", events, "-n", "2", "--device", "cpu"]
    for plane, path in weights.items():
        base += ["-w", f"{plane}:{path}"]
    sd, tar = tame_tar
    ckdir = d / "ck"
    ckdir.mkdir()
    save_reference_checkpoint(sd, checkpoint_path(str(ckdir), 8))
    cfg = d / "cfg.json"
    cfg.write_text(json.dumps({"model": {"inplanes": 16}}))
    reports = []
    for ck in (["-c", tar], ["-c", str(ckdir), "--config", str(cfg)]):
        out = str(d / f"rep{len(reports)}.json")
        rc = golden_parity.main(base + ck + ["-o", out])
        rep = json.loads(open(out).read())
        assert rc == (0 if rep["ok"] else 1)
        assert rep["mode"] == "official" and set(rep["planes"]) == {
            "0", "1", "2"}
        for m in rep["planes"].values():
            assert m["n_pixels"] > 0 and m["n_entries"] == 2.0
            assert 0.0 <= m["label_agreement"] <= 1.0
        reports.append(rep)
    assert reports[0] == reports[1]
    capsys.readouterr()
    with pytest.raises(SystemExit):
        golden_parity.main(["-i", events, "--device", "cpu"])
