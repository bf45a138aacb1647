"""ASPP-ResNet through the port's entry points on the CPU: the
precropped and wholeview CLIs against the JAX package's CLIs on the same
ASPP .tar (float32, ``--arch aspp_resnet``), the default ``--arch`` on an
ASPP .tar, the serve loop and the training CLI with
``model.name=aspp_resnet``.

Weights: "tame" seeded ASPP weights — random_state_dict(seed=2,
arch="aspp_resnet") with the classifier scaled by 3e-5 — so that float32
probabilities are not saturated to 0 or 1 and a probability difference
means something. tests/test_torch_wholeview.py tames the UResNet's by
3e-4; ASPP's seeded logits reach ≈ 6e4 on these crops, twice the
UResNet's, and 3e-4 still leaves pixels at exactly 1. Bars, as the
UResNet CLI tests: argmax on ≥ 99.9% of pixels and max|Δp| ≤ 1e-3
against JAX."""
import json

import numpy as np
import pytest
import torch

from ubresnet_tpu.cli.infer_precropped import main as jax_precropped
from ubresnet_tpu.cli.infer_wholeview import main as jax_wholeview
from ubresnet_tpu_torch.cli.infer_precropped import main as precropped
from ubresnet_tpu_torch.cli.infer_wholeview import main as wholeview
from ubresnet_tpu_torch.cli.serve import main as serve
from ubresnet_tpu_torch.cli.train import main as train_main
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.data.uevt import EventFileReader
from ubresnet_tpu_torch.deploy.weights import (
    load_reference_checkpoint,
    random_state_dict,
    save_reference_checkpoint,
)
from ubresnet_tpu_torch.models import ASPPResNet

torch.set_num_threads(1)
ARCH = ["--arch", "aspp_resnet"]
TILES = ["--tile-rows", "64", "--tile-cols", "64", "--overlap-rows", "8",
         "--overlap-cols", "8", "--crop-batch", "4"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("aspp_cli")
    sd = random_state_dict(seed=2, arch="aspp_resnet")
    sd["conv11.weight"] = sd["conv11.weight"] * 3e-5
    return {"dir": d,
            "tar": save_reference_checkpoint(sd, str(d / "aspp.tar")),
            "crops": make_synthetic_file(str(d / "crops.uevt"), n_events=4,
                                         hw=(64, 64), seed=5),
            "planes": make_synthetic_file(str(d / "planes.uevt"),
                                          n_events=2, hw=(128, 192),
                                          seed=5)}


def _scores(path, producer):
    r = EventFileReader(path)
    return np.stack([np.stack([im.pixels.astype(np.float32)
                               for im in r.read_entry(i)[producer]], -1)
                     for i in range(len(r))])


def _close(port, ref):
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.sum(-1), 1.0, atol=1e-4)
    assert 0.0 < ref.max() < 1.0  # the tame weights leave room
    assert (port.argmax(-1) == ref.argmax(-1)).mean() >= 0.999
    assert np.abs(port - ref).max() <= 1e-3


def test_precropped_cli_matches_jax(files):
    d = files["dir"]
    common = ["-i", files["crops"], "-c", files["tar"], "-b", "3", "--f32",
              *ARCH]
    out_port, out_jax = str(d / "port.uevt"), str(d / "jax.uevt")
    assert precropped(common + ["-o", out_port, "--device", "cpu"]) == 0
    assert jax_precropped(common + ["-o", out_jax]) == 0
    _close(_scores(out_port, "uburn_plane2"),
           _scores(out_jax, "uburn_plane2"))


@pytest.mark.parametrize("precision", [["--f32"], []], ids=["f32", "bf16"])
def test_default_arch_runs_an_aspp_tar_as_aspp(files, precision):
    """The default --arch on an ASPP .tar builds the ASPP model (as the
    JAX package picks its importer by the keys) and writes the same
    bytes as --arch aspp_resnet."""
    d = files["dir"]
    base = ["-i", files["crops"], "-c", files["tar"], "-b", "2",
            "--device", "cpu", *precision]
    out = [str(d / f"default{len(precision)}.uevt"),
           str(d / f"aspp{len(precision)}.uevt")]
    assert precropped(base + ["-o", out[0]]) == 0
    assert precropped(base + ["-o", out[1], *ARCH]) == 0
    a, b = (open(p, "rb").read() for p in out)
    assert a == b


@pytest.mark.parametrize("mode", [[], ["--stitched"]],
                         ids=["spatial", "stitched"])
def test_wholeview_cli_matches_jax(files, mode):
    d = files["dir"]
    tag = len(mode)
    common = ["-i", files["planes"], "-c", files["tar"], "--f32", *ARCH,
              *TILES, *mode]
    out_port, out_jax = (str(d / f"wv_{who}{tag}.uevt")
                         for who in ("port", "jax"))
    assert wholeview(common + ["-o", out_port, "--device", "cpu"]) == 0
    assert jax_wholeview(common + ["-o", out_jax]) == 0
    port = _scores(out_port, "ubsnet_plane2")
    assert port.shape == (2, 128, 192, 3)
    _close(port, _scores(out_jax, "ubsnet_plane2"))


def test_serve_once_runs_aspp(files, capsys):
    """serve --once --arch aspp_resnet over a precropped file writes the
    precropped CLI's scores."""
    d = files["dir"]
    watch, out = d / "watch", d / "served"
    watch.mkdir()
    make_synthetic_file(str(watch / "a.uevt"), n_events=3, hw=(64, 64),
                        seed=5)
    assert serve(["--watch-dir", str(watch), "--out-dir", str(out), "-c",
                  files["tar"], "--once", "-b", "2", "--f32", "--device",
                  "cpu", *ARCH]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines[-1] == {"shutdown": True, "served": 1}
    ref = str(d / "serve_ref.uevt")
    assert precropped(["-i", str(watch / "a.uevt"), "-o", ref, "-c",
                       files["tar"], "-b", "2", "--f32", "--device",
                       "cpu"]) == 0
    np.testing.assert_array_equal(
        _scores(str(out / "a_scores.uevt"), "uburn_plane2"),
        _scores(ref, "uburn_plane2"))


def test_arch_aspp_on_a_uresnet_tar_exits(files):
    d = files["dir"]
    tar = save_reference_checkpoint(random_state_dict(seed=0),
                                    str(d / "uresnet.tar"))
    with pytest.raises(SystemExit, match="no ASPP_layer_enc3 keys"):
        precropped(["-i", files["crops"], "-o", str(d / "x.uevt"), "-c", tar,
                    "--device", "cpu", *ARCH])


def test_train_cli_trains_aspp(files, capsys):
    """``--set model.name=aspp_resnet``: two iterations (bf16, the train
    zone's plain versions) with a validation, finite losses, and a final
    reference .tar that holds an ASPP-ResNet and scores."""
    d = files["dir"]
    cfg = {"model": {"precision": "bf16"}, "optim": {"lr": 1e-3},
           "train_data": {"files": [files["crops"]], "batch_size": 2,
                          "n_threads": 1, "sparse_bucket": 512},
           "valid_data": {"files": [files["crops"]], "batch_size": 2,
                          "n_threads": 1},
           "num_iters": 2, "print_every": 1, "valid_every": 2,
           "valid_batches": 1, "checkpoint_dir": str(d / "ckpt"), "seed": 1}
    path = d / "train.json"
    path.write_text(json.dumps(cfg))
    assert train_main(["--config", str(path), "--device", "cpu", "--set",
                       "model.name=aspp_resnet"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.rfind("\n{\n") + 1:])
    assert summary["final_iter"] == 2 and "error" not in summary
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("iter ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    sd, info = load_reference_checkpoint(summary["final_checkpoint"])
    assert info["arch"] == "aspp_resnet"
    x = torch.from_numpy(_scores(files["crops"], "wire")[:1])
    with torch.inference_mode():
        lp = ASPPResNet(sd, device="cpu")(x)
    torch.testing.assert_close(lp.exp().sum(-1), torch.ones(1, 64, 64))
