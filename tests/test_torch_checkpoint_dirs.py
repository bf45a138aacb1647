"""The deploy CLIs (infer_precropped, infer_wholeview, serve) on the
port's training checkpoint directories (train/checkpoint.py:
``step_<N>.tar``, ``best.tar``): ``-c DIR --config cfg`` scores with the
newest step and ``--best`` with best.tar, the same bytes as ``-c`` on
that file, as the JAX package's flags pick from its orbax directories;
what they cannot read exits."""
import json

import pytest
import torch

from ubresnet_tpu_torch.cli.infer_precropped import main as precropped
from ubresnet_tpu_torch.cli.infer_wholeview import main as wholeview
from ubresnet_tpu_torch.cli.serve import main as serve
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.deploy.weights import random_state_dict
from ubresnet_tpu_torch.models import get_model
from ubresnet_tpu_torch.train.checkpoint import save_checkpoint
from ubresnet_tpu_torch.train.optimizers import make_optimizer
from ubresnet_tpu_torch.train.step import create_train_state

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckdir(tmp_path_factory):
    """A directory as training leaves it: steps 2 and 4 (the newest) and
    best.tar (step 2's weights), each from other seeded weights, written
    by save_checkpoint; and the run's config."""
    d = tmp_path_factory.mktemp("ck")
    run = d / "run"
    for step, seed, best in ((2, 1, True), (4, 2, False)):
        model = get_model("uresnet", random_state_dict(seed=seed, inplanes=4),
                          device="cpu", train=True)
        state = create_train_state(model, make_optimizer(model.parameters()))
        state.step = step
        save_checkpoint(str(run), state, best=best)
    cfg = d / "cfg.json"
    cfg.write_text(json.dumps({"model": {"inplanes": 4}}))
    data = make_synthetic_file(str(d / "in.uevt"), n_events=2, hw=(64, 64),
                               seed=3)
    return d, run, str(cfg), data


def _run(cli, d, ck, tag):
    """Scores written by ``cli`` with checkpoint arguments ``ck``."""
    if cli == "serve":
        out = d / f"serve_{tag}"
        assert serve(["--watch-dir", str(d / "watch"), "--out-dir", str(out),
                      "--once", "--device", "cpu", *ck]) == 0
        return (out / "in_scores.uevt").read_bytes()
    out = d / f"{cli}_{tag}.uevt"
    fn = precropped if cli == "precropped" else wholeview
    assert fn(["-i", str(d / "in.uevt"), "-o", str(out), "--device", "cpu",
               *ck]) == 0
    return out.read_bytes()


@pytest.mark.parametrize("cli", ["precropped", "wholeview", "serve"])
def test_directory_reads_the_newest_step_or_best(ckdir, cli, capsys):
    d, run, cfg, data = ckdir
    if cli == "serve":
        (d / "watch").mkdir(exist_ok=True)
        (d / "watch" / "in.uevt").write_bytes((d / "in.uevt").read_bytes())
    newest = _run(cli, d, ["-c", str(run), "--config", cfg], "dir")
    assert newest == _run(cli, d, ["-c", str(run / "step_00000004.tar")],
                          "step4")
    best = _run(cli, d, ["-c", str(run), "--config", cfg, "--best"],
                "dirbest")
    assert best == _run(cli, d, ["-c", str(run / "best.tar")], "best")
    assert best == _run(cli, d, ["-c", str(run / "step_00000002.tar")],
                        "step2")
    assert best != newest
    capsys.readouterr()


def test_what_a_directory_cannot_give_exits(ckdir, tmp_path):
    d, run, cfg, data = ckdir
    base = ["-i", data, "-o", str(tmp_path / "o.uevt"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--config required"):
        precropped(base + ["-c", str(run)])
    empty = tmp_path / "orbax"
    empty.mkdir()
    with pytest.raises(SystemExit, match="export_torch"):
        precropped(base + ["-c", str(empty), "--config", cfg])
    nobest = tmp_path / "nobest"
    nobest.mkdir()
    (nobest / "step_00000003.tar").write_bytes(
        (run / "step_00000004.tar").read_bytes())
    with pytest.raises(SystemExit, match="best.tar"):
        precropped(base + ["-c", str(nobest), "--config", cfg, "--best"])
    wide = tmp_path / "wide.json"
    wide.write_text(json.dumps({"model": {"inplanes": 16}}))
    with pytest.raises(SystemExit, match="'inplanes': 16"):
        precropped(base + ["-c", str(run), "--config", str(wide)])
    aspp = tmp_path / "aspp.json"
    aspp.write_text(json.dumps({"model": {"name": "aspp_resnet",
                                          "inplanes": 4}}))
    with pytest.raises(SystemExit, match="aspp_resnet"):
        precropped(base + ["-c", str(run), "--config", str(aspp)])
