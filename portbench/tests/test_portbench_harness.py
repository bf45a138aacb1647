"""The benchmark's hygiene and its data-driven shape, on the CPU:

* no module under portbench/ imports JAX or the JAX package (top-level
  names compared whole: the port's name begins with the JAX package's);
* the reference imports nothing of the port;
* nothing reads the JAX package's bench harness or its result files;
* BENCHMARK.json keeps to the benchmark's contract, and every file it
  names is there;
* a cell added as new files only is found and parsed, and so is an
  architecture: a configuration's ``arch`` picks its reference, weights
  and FLOP count, and no code outside reference/ names one;
* a run without a card, or in a directory that holds only the benchmark,
  prints no result and fails;
* the host-clock readings of a traced run take only the calls made once
  no profile runs.
"""
import ast
import json
import re
import shutil
import subprocess
import sys
import time

import pytest

from portbench.lib import common, readers, trace

BENCH = common.BENCH_DIR
ROOT = common.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def sources(under=BENCH):
    return sorted(p for p in under.rglob("*.py") if "__pycache__" not in
                  p.parts)


def imported(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not (
                node.level):
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_jax_anywhere():
    for p in sources():
        bad = imported(p) & set(common.FORBIDDEN)
        assert not bad, f"{p} imports {bad}"


def test_reference_imports_nothing_of_the_port():
    for p in sources(BENCH / "reference"):
        tops = imported(p)
        assert "ubresnet_tpu_torch" not in tops, p
        assert tops <= {"__future__", "math", "typing", "torch", "portbench"}


def test_nothing_reads_the_jax_bench_files():
    pattern = re.compile(r"(?<!\w)bench\.py|BENCH_r\d|BENCH_\*|"
                         r"BASELINE\.json|bench_baseline|MULTICHIP_r")
    for p in sorted(BENCH.rglob("*")):
        if p.is_file() and p.suffix in (".py", ".json") and (
                "tests" not in p.parts):
            assert not pattern.search(p.read_text()), p


def test_forbidden_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ubresnet_tpu_torch_x", object())
    assert "ubresnet_tpu_torch_x" not in common.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ubresnet_tpu.fake", object())
    assert common.forbidden_modules() == ["ubresnet_tpu"]


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"]: w for w in b["workloads"]}
    configs = {c["name"] for c in b["configs"]}
    names = list(e2e) + [m["name"] for m in b["per_layer"]] + list(cells)
    names += list(configs)
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(
            "portbench/")
        assert not c["reduced"]
    for w in b["workloads"]:
        assert w["chips"] == 1 and w["config"] in configs
        assert len(w["why"]) <= 200
        assert (BENCH / "cells" / f"{w['name']}.json").is_file()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for c in m["workloads"]:
            moved = e2e[m["moves"]]
            assert c in moved.get("workloads", cells), (m["name"], c)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        cell = common.load_cell(c, b)
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        assert {"setup_s"} <= {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert any("mfu" in m["name"] for m in cell.per_layer)
    assert len(json.dumps(b)) < 64 * 1024


def test_a_cell_added_as_files_is_found(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "u16.score.b8", "config": "uresnet16",
                           "traffic": "score_512_b8", "chips": 1,
                           "why": "a smaller batch"})
    (copy / "BENCHMARK.json").write_text(json.dumps(b))
    tr = json.loads((BENCH / "traffic" / "score_512_b16.json").read_text())
    tr["batch"] = 8
    (copy / "portbench" / "traffic" / "score_512_b8.json").write_text(
        json.dumps(tr))
    (copy / "portbench" / "cells" / "u16.score.b8.json").write_text(
        json.dumps({"config": "uresnet16", "traffic": "score_512_b8",
                    "limits": {"max_abs_dp": 1.0}}))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.'); "
         "from portbench.lib import common; "
         "c = common.load_cell('u16.score.b8'); "
         "print(c.traffic['batch'], c.config['inplanes'], "
         "sorted(m['name'] for m in c.end_to_end))"],
        cwd=copy, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:2] == ["8", "16"]
    assert "setup_s" in out.stdout


# A second architecture as files only: a reference with a dilated 3x3
# conv (bias, BN) and a grouped transposed conv, and a configuration
# that names it.
TOY_REFERENCE = """
import torch
import torch.nn.functional as F

from portbench.reference import shared


def layout(cfg):
    c, ci = cfg["inplanes"], cfg["input_channels"]
    return ([("dil.weight", (c, ci, 3, 3), 9 * c),
             ("up.weight", (c, c // 2, 4, 4), 16 * c)],
            [("dil.bias", 9 * ci)], [("bn", c)])


class Net(shared.Layers):
    def __call__(self, x):
        sd = self.sd
        y = F.conv2d(x, sd["dil.weight"], sd["dil.bias"], padding=3,
                     dilation=3)
        y = torch.relu(self.bn(y, "bn"))
        return F.conv_transpose2d(y, weight=sd["up.weight"], stride=2,
                                  padding=1, groups=2)
"""

TOY_RUN = """
import json, sys
sys.path.insert(0, '.')
import torch
from portbench.lib import common
from portbench.reference import weights
from portbench.work import arith
cfg = common.load_json(common.BENCH_DIR / 'configs' / 'toy8.json')
ref = common.reference_module(cfg)
sd = weights.make_state_dict(cfg, 2 ** 33 + 1, 'cpu',
                             torch.rand(3, 16, 16, 1))
print(json.dumps({'file': ref.__file__,
                  'shapes': {k: list(v.shape) for k, v in sd.items()},
                  'calibrated': float((sd['bn.running_var'] - 1).abs().max()),
                  'macs': [arith.forward_macs(cfg, (16, 16)),
                           arith.forward_macs(cfg, (8, 24))]}))
"""


def test_an_architecture_added_as_files_is_found(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "portbench" / "reference" / "toy.py").write_text(TOY_REFERENCE)
    (copy / "portbench" / "configs" / "toy8.json").write_text(json.dumps(
        {"name": "toy8", "arch": "toy", "inplanes": 8,
         "input_channels": 1}))
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=copy,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["file"] == str(copy / "portbench" / "reference" / "toy.py")
    assert got["shapes"] == {
        "dil.weight": [8, 1, 3, 3], "up.weight": [8, 4, 4, 4],
        "dil.bias": [8], "bn.weight": [8], "bn.bias": [8],
        "bn.running_mean": [8], "bn.running_var": [8]}
    assert got["calibrated"] > 0
    # the dilated conv: out pixels · C_in · 3 · 3 per output channel; the
    # transposed conv (groups 2): in pixels · C_in · (C_out / 2) · 4 · 4
    assert got["macs"] == [h * w * (8 * 1 * 9 + 8 * 4 * 16)
                           for h, w in ((16, 16), (8, 24))]


def test_an_unknown_arch_names_its_missing_file():
    cfg = {"name": "nosuch8", "arch": "nosuch", "inplanes": 8}
    with pytest.raises(FileNotFoundError, match="reference/nosuch.py"):
        common.reference_module(cfg)
    from portbench.work import arith

    with pytest.raises(FileNotFoundError, match="reference/nosuch.py"):
        arith.forward_macs(cfg, (16, 16))


def test_only_reference_code_names_an_architecture():
    from ubresnet_tpu_torch.models.registry import MODEL_REGISTRY

    archs = set(MODEL_REGISTRY) | {
        json.loads(p.read_text())["arch"]
        for p in (BENCH / "configs").glob("*.json")}
    assert "uresnet" in archs
    for p in sources():
        if {"reference", "tests"} & set(p.relative_to(BENCH).parts):
            continue
        text = p.read_text().lower()
        assert not [a for a in archs if a in text], p


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "u16.score.b16",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if "found 0" not in out.stderr:
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "u16.score.b16",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "ubresnet_tpu_torch" in out.stderr


def test_host_readings_leave_out_profiled_calls():
    import torch

    untraced = trace.Stretch(torch, False, calls=3)
    assert not untraced.quiet(time.perf_counter())
    untraced.open()
    assert untraced.quiet(time.perf_counter())
    traced = trace.Stretch(torch, True, calls=3)
    assert not traced.quiet(time.perf_counter())   # a profile runs
    ctx = {"work": {"flops": 989e12},
           "quiet": common.quiet_rate(0, traced.quiet_from, 5.0)}
    assert readers.mfu(ctx) is None
    ctx["quiet"] = common.quiet_rate(10, 1.0, 5.0)
    assert readers.mfu(ctx) == pytest.approx(250.0)
