"""The port's QAT entry points on the CPU: the training CLI with
``--set model.qat=true`` (64x64 synthetic events, batch 2, 3 iterations
with a validation pass under QAT), the int8 ladder tool at
UBTPU_BENCH_HW=64, and the train-step profiler's configuration matrix
against the JAX package's tools/profile_train.py."""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from ubresnet_tpu_torch.cli.train import main
from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.data.synthetic import make_synthetic_file
from ubresnet_tpu_torch.deploy.weights import load_reference_checkpoint
from ubresnet_tpu_torch.models import UResNet

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("qat_cli")
    return d, make_synthetic_file(str(d / "train.uevt"), n_events=6,
                                  hw=(64, 64), seed=3)


def test_cli_trains_with_qat(data, capsys):
    """model.qat=true: the trainer runs Policy.quant_train (train and
    validation fake-quantized), finite losses, and a final reference
    .tar that the eval model scores to probabilities summing to 1."""
    d, path = data
    cfg = {"model": {"precision": "bf16"}, "optim": {"lr": 1e-3},
           "train_data": {"files": [path], "batch_size": 2, "n_threads": 1,
                          "sparse_bucket": 512},
           "valid_data": {"files": [path], "batch_size": 2, "n_threads": 1},
           "num_iters": 3, "print_every": 1, "valid_every": 2,
           "valid_batches": 1, "checkpoint_every": 3,
           "checkpoint_dir": str(d / "ckpt_qat"), "seed": 1}
    cfg_path = d / "cfg_qat.json"
    cfg_path.write_text(json.dumps(cfg))
    rc = main(["--config", str(cfg_path), "--set", "model.qat=true",
               "--set", "model.qat_percentile=99.9", "--device", "cpu"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.rfind("\n{\n") + 1:])
    assert rc == 0 and "error" not in summary, out
    assert summary["final_iter"] == 3 and summary["nan_steps_skipped"] == 0
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("iter ")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    sd, _ = load_reference_checkpoint(summary["final_checkpoint"])
    x = np.random.RandomState(4).rand(1, 64, 64, 1).astype(np.float32)
    for policy in (Policy.f32(), dataclasses.replace(
            Policy.f32(), quant_train=True, quant_percentile=99.9)):
        with torch.inference_mode():
            lp = UResNet(sd, policy=policy, device="cpu")(torch.from_numpy(x))
        assert torch.isfinite(lp).all()
        torch.testing.assert_close(lp.exp().sum(-1), torch.ones(1, 64, 64))


# the JAX tool's output keys (tools/int8_ladder.py:127-146)
LADDER_KEYS = {"train_steps", "hw", "inplanes", "ptq_absmax", "ptq_p99.9",
               "ptq_p99.99", "qat_absmax", "qat_p99.9",
               "qat_f32_argmax_vs_pre_qat"}


def test_int8_ladder_prints_one_json_line():
    env = dict(os.environ, UBTPU_BENCH_HW="64", UBTPU_BENCH_TRAIN_BATCH="2",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ubresnet_tpu_torch.tools.int8_ladder", "2",
         "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == LADDER_KEYS
    assert (res["train_steps"], res["hw"], res["inplanes"]) == (2, 64, 16)
    for key in LADDER_KEYS - {"train_steps", "hw", "inplanes",
                              "qat_f32_argmax_vs_pre_qat"}:
        assert set(res[key]) == {"prob_mae_vs_f32", "argmax_agreement"}
        assert 0 <= res[key]["prob_mae_vs_f32"] < 1
        assert 0 < res[key]["argmax_agreement"] <= 1
    assert 0 < res["qat_f32_argmax_vs_pre_qat"] <= 1


def _jax_tool_matrix():
    """(batches, [(fused_train, fused_train_deconv), ...]) of the JAX
    package's tools/profile_train.py, read from its source: the
    ``drive(B, n, tag, **flags)`` calls in its ``for B in (...)`` loop
    over Policy.tpu() (both flags off by default)."""
    tree = ast.parse((ROOT / "tools" / "profile_train.py").read_text())
    loop = next(n for n in ast.walk(tree) if isinstance(n, ast.For)
                and isinstance(n.target, ast.Name) and n.target.id == "B")
    batches = tuple(ast.literal_eval(loop.iter))
    flags = []
    for call in ast.walk(loop):
        if isinstance(call, ast.Call) and getattr(call.func, "id", "") \
                == "drive":
            kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords}
            flags.append((kw.get("fused_train", False),
                          kw.get("fused_train_deconv", False)))
    return batches, flags


def test_profile_train_matrix_is_the_jax_tools():
    from ubresnet_tpu_torch.tools import profile_train

    batches, flags = _jax_tool_matrix()
    assert profile_train.BATCHES == batches == (16, 32)
    ours = [dataclasses.replace(Policy(), **ov) for _, ov in
            profile_train.CONFIGS]
    assert [(p.fused_train, p.fused_train_deconv) for p in ours] == flags
    assert len(flags) == 3
