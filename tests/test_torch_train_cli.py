"""The port's training CLI end to end on the CPU
(ubresnet_tpu_torch.cli.train --device cpu): a synthetic .uevt at 64x64,
batch 2, 3 iterations with validation, periodic and best checkpoints
and the default sparse transfer, in f32 and in bf16 (the kernel zone's
plain versions). Its reference-format .tar carries trained BN
statistics; the port's eval UResNet and the JAX package (through its
importer) read it and give the same f32 eval logits within
1e-5·max|logit| (the eval-mode bound of tests/test_torch_model.py), and
a resumed run continues from the saved iteration."""
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ubresnet_tpu.core.precision import Policy as JaxPolicy
from ubresnet_tpu.deploy.importers import import_uresnet_state_dict
from ubresnet_tpu.models import get_model as jax_get_model
from ubresnet_tpu_torch.cli.train import main
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
from ubresnet_tpu_torch.models import UResNet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_cli")
    return d, make_synthetic_file(str(d / "train.uevt"), n_events=6,
                                  hw=(64, 64), seed=3)


def _config(d, data, precision, **extra):
    cfg = {"model": {"precision": precision}, "optim": {"lr": 1e-3},
           "train_data": {"files": [data], "batch_size": 2, "n_threads": 1,
                          "sparse_bucket": 512},
           "valid_data": {"files": [data], "batch_size": 2, "n_threads": 1},
           "num_iters": 3, "print_every": 1, "valid_every": 2,
           "valid_batches": 1, "checkpoint_every": 2,
           "checkpoint_dir": str(d / f"ckpt_{precision}"), "seed": 1}
    cfg.update(extra)
    path = d / f"cfg_{precision}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _run(capsys, argv):
    rc = main(argv)
    out = capsys.readouterr().out
    return rc, json.loads(out[out.rfind("\n{\n") + 1:]), out


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_cli_trains_and_writes_a_reference_tar(data, capsys, precision):
    d, path = data
    rc, summary, out = _run(capsys, ["--config", _config(d, path, precision),
                                     "--device", "cpu"])
    assert rc == 0 and "error" not in summary
    assert summary["final_iter"] == 3 and summary["nan_steps_skipped"] == 0
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("iter ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    tar = summary["final_checkpoint"]
    assert tar.endswith("step_00000003.tar")
    assert (d / f"ckpt_{precision}" / "best.tar").exists()
    payload = torch.load(tar, map_location="cpu", weights_only=False)
    assert payload["iter"] == 3 and payload["optimizer"]["count"] == 3


def test_tar_reads_the_same_in_both_packages(data, capsys):
    """f32 eval logits of the CLI-trained .tar: port eval UResNet ≡ JAX
    UResNet (Policy.f32) loaded through its importer. The BN running
    stats were moved by three train steps, so this holds the trained
    statistics across the packages."""
    d, path = data
    ckpt = d / "ckpt_f32" / "step_00000003.tar"
    if not ckpt.exists():
        _run(capsys, ["--config", _config(d, path, "f32"), "--device", "cpu"])
    sd, _ = load_reference_checkpoint(str(ckpt))
    x = np.random.RandomState(4).rand(1, 64, 64, 1).astype(np.float32)
    with torch.inference_mode():
        got = UResNet(sd, policy=Policy.f32(), device="cpu")(
            torch.from_numpy(x), logits=True).numpy()
    variables = import_uresnet_state_dict({k: v.numpy() for k, v in sd.items()})
    model = jax_get_model("uresnet", policy=JaxPolicy.f32(), input_channels=1,
                          inplanes=16)
    want = np.asarray(jax.jit(
        lambda v, x: model.apply(v, x, train=False, logits=True))(
        variables, jnp.asarray(x)))
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())
    init = load_reference_checkpoint(str(d / "ckpt_f32" / "step_00000002.tar"))
    assert not torch.equal(init[0]["bn1.running_mean"], sd["bn1.running_mean"])


def test_resume_picks_up_at_the_saved_iteration(data, capsys):
    d, path = data
    cfg = _config(d, path, "f32", checkpoint_dir=str(d / "ckpt_resume"))
    rc, summary, _ = _run(capsys, ["--config", cfg, "--device", "cpu"])
    assert rc == 0 and summary["final_iter"] == 3
    rc, summary, out = _run(capsys, ["--config", cfg, "--device", "cpu",
                                     "--set", "resume=true",
                                     "--set", "num_iters=5"])
    assert rc == 0 and "resumed from iter 3" in out
    assert summary["final_iter"] == 5
    iters = [line.split()[1] for line in out.splitlines()
             if line.startswith("iter ")]
    assert iters == ["4/5", "5/5"]


def test_fault_at_iter_exits_once_and_resumes(data, capsys):
    """fault_at_iter: a hard exit (status 23, no final checkpoint) after
    that iteration, once; the resumed run passes it and finishes."""
    d, path = data
    cfg = _config(d, path, "f32", checkpoint_dir=str(d / "ckpt_fault"),
                  fault_at_iter=2)
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "ubresnet_tpu_torch.cli.train", "--config",
         cfg, "--device", "cpu"], capture_output=True, text=True, cwd=root,
        timeout=300)
    assert proc.returncode == 23, proc.stderr
    assert "fault injection: hard exit after iter 2" in proc.stdout
    assert (d / "ckpt_fault" / ".fault_injected").exists()
    assert (d / "ckpt_fault" / "step_00000002.tar").exists()
    rc, summary, out = _run(capsys, ["--config", cfg, "--device", "cpu",
                                     "--set", "resume=true"])
    assert rc == 0 and "resumed from iter 2" in out
    assert summary["final_iter"] == 3


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_debug_dump_writes_jax_pngs(data, capsys, native):
    """--debug-dump DIR: the first batch's adc_i / label_i / weight_i
    PNGs, byte-equal to the JAX CLI's for the same config (one loader
    thread and one seed: the C++ filler or the Python loader gives both
    packages the same batch), then exit 0."""
    from ubresnet_tpu.cli.train import main as jax_main

    d, path = data
    cfg = _config(d, path, "f32", checkpoint_dir=str(d / "ckpt_dump"))
    cfg_native = ["--set", f"train_data.native={json.dumps(native)}"]
    port_dir, jax_dir = d / f"dump_port_{native}", d / f"dump_jax_{native}"
    assert main(["--config", cfg, *cfg_native, "--debug-dump",
                 str(port_dir)]) == 0
    assert jax_main(["--config", cfg, *cfg_native, "--debug-dump",
                     str(jax_dir)]) == 0
    assert "dumped 2 samples" in capsys.readouterr().out
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(f"{k}_{i}.png" for k in ("adc", "label",
                                                   "weight")
                           for i in range(2))
    for name in names:
        png = (port_dir / name).read_bytes()
        assert png.startswith(b"\x89PNG") and png == (
            jax_dir / name).read_bytes()
    assert not (d / "ckpt_dump").exists()  # no training ran


def test_trace_writes_a_chrome_trace(data, capsys):
    """--trace DIR: training runs inside torch.profiler and DIR holds a
    Chrome trace of it (CPU activities here; on the card CUDA too)."""
    d, path = data
    cfg = _config(d, path, "bf16", checkpoint_dir=str(d / "ckpt_trace"),
                  num_iters=1, valid_data=None)
    rc, summary, _ = _run(capsys, ["--config", cfg, "--device", "cpu",
                                   "--trace", str(d / "trace")])
    assert rc == 0 and summary["final_iter"] == 1
    events = json.loads((d / "trace" / "trace.json").read_text())[
        "traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::conv") for n in names), sorted(names)[:20]
