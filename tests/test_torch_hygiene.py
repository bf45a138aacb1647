"""The port stands alone: ubresnet_tpu_torch and chip_smoke.py import
neither jax nor the JAX package, and nothing runs on the CPU unless
the caller asks for it."""
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from ubresnet_tpu_torch.utils.platform import resolve_device

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ubresnet_tpu_torch"


def test_import_pulls_in_no_jax():
    code = (
        "import pkgutil, sys, ubresnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(ubresnet_tpu_torch.__path__,\n"
        "                               'ubresnet_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib', 'flax'))\n"
        "             or n == 'ubresnet_tpu' or n.startswith('ubresnet_tpu.'))\n"
        "n = sum(n.startswith('ubresnet_tpu_torch.') for n in sys.modules)\n"
        "print(n, bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", proc.stdout


@pytest.mark.parametrize("module", ["ubresnet_tpu_torch.ops.quant",
                                    "ubresnet_tpu_torch.deploy.precropped",
                                    "ubresnet_tpu_torch.cli.infer_precropped"])
def test_int8_modules_pull_in_no_jax(module):
    """The int8 deploy path's modules (PTQ, calibration, the --int8 CLI)
    import without jax or the JAX package, as a fresh process sees."""
    code = (f"import sys, {module}\n"
            "print(sorted(n for n in sys.modules if n == 'jax'\n"
            "             or n.startswith(('jax.', 'jaxlib', 'flax'))\n"
            "             or n == 'ubresnet_tpu'\n"
            "             or n.startswith('ubresnet_tpu.')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_parity_stack_pulls_in_no_jax():
    """The Caffe parity stack and its CLIs, describe and the checkpoint
    directory loader import without jax or the JAX package (a fresh
    process), though the JAX package holds JAX-free modules of the same
    names (protobuf_lite, align, ssnet2018): the port keeps copies."""
    mods = ["parity", "parity.caffe", "parity.protobuf_lite", "parity.align",
            "parity.compare", "parity.evaluate", "models.ssnet2018",
            "cli.infer_caffe", "cli.compare", "cli.evaluate",
            "cli.golden_parity", "cli.common", "utils.describe"]
    code = ("import sys\n"
            + "".join(f"import ubresnet_tpu_torch.{m}\n" for m in mods)
            + "print(sorted(n for n in sys.modules if n == 'jax'\n"
            "             or n.startswith(('jax.', 'jaxlib', 'flax'))\n"
            "             or n == 'ubresnet_tpu'\n"
            "             or n.startswith('ubresnet_tpu.')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


@pytest.mark.parametrize("module", ["ubresnet_tpu_torch.tools.int8_ladder",
                                    "ubresnet_tpu_torch.tools.profile_train",
                                    "ubresnet_tpu_torch.tools.kernel_ab"])
def test_tools_pull_in_no_jax_and_no_bench(module):
    """The port's tools keep their own copies of what the JAX tools take
    from the repo-root bench.py: importing one (a fresh process) brings
    in neither jax, the JAX package nor bench, and no source line of
    the tools imports bench."""
    code = (f"import sys, {module}\n"
            "print(sorted(n for n in sys.modules if n in ('jax', 'bench')\n"
            "             or n.startswith(('jax.', 'jaxlib', 'flax'))\n"
            "             or n == 'ubresnet_tpu'\n"
            "             or n.startswith('ubresnet_tpu.')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout
    pat = re.compile(r"^\s*(import bench\b|from bench\b)")
    src = (PORT / "tools" / (module.rsplit(".", 1)[1] + ".py")).read_text()
    assert not any(pat.search(line) for line in src.splitlines())


@pytest.mark.parametrize("module", ["ubresnet_tpu_torch.parallel.sharding",
                                    "ubresnet_tpu_torch.core.mesh",
                                    "ubresnet_tpu_torch.deploy.wholeview",
                                    "ubresnet_tpu_torch.cli.infer_wholeview",
                                    "ubresnet_tpu_torch.train.trainer"])
def test_sharding_modules_pull_in_no_jax(module):
    """The row-sharded whole planes and the model axis (sharding, mesh,
    the wholeview runner and CLI, the trainer) import without jax or the
    JAX package, as a fresh process sees."""
    code = (f"import sys, {module}\n"
            "print(sorted(n for n in sys.modules if n == 'jax'\n"
            "             or n.startswith(('jax.', 'jaxlib', 'flax'))\n"
            "             or n == 'ubresnet_tpu'\n"
            "             or n.startswith('ubresnet_tpu.')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_model_axis_mesh_no_longer_raises():
    """make_mesh(model_axis=2) over a world of 2 is a (1, 2) mesh in
    JAX's order; only a world the axis does not divide raises."""
    from ubresnet_tpu_torch.core.mesh import make_mesh

    mesh = make_mesh(2, model_axis=2)
    assert (mesh.size, mesh.data_size, mesh.model_size) == (2, 1, 2)
    assert (mesh.data_rank, mesh.model_rank) == (0, 0)
    with pytest.raises(ValueError):
        make_mesh(2, model_axis=3)


def test_sources_name_no_jax():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh")]
    files.append(ROOT / "chip_smoke.py")
    pat = re.compile(r"import jax|from jax|\bubresnet_tpu\.")
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert len(files) > 20 and hits == []


def test_sources_spawn_no_jax_module():
    """No string of the port or of chip_smoke.py names a JAX-package
    module to run: no ``-m ubresnet_tpu.…`` in a command line or an
    argument list, no module name assembled from "ubresnet_tpu" (the
    launcher is the port's first module that spawns modules by name);
    and the launcher's own module names are the port's."""
    from ubresnet_tpu_torch.cli import launch

    files = [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]
    pat = re.compile(r"-m\s+ubresnet_tpu(?!_torch)"
                     r"|[\"']-m[\"']\s*,\s*[\"']ubresnet_tpu(?!_torch)"
                     r"|[\"']ubresnet_tpu[\"']\s*\+"
                     r"|[\"']ubresnet_tpu(?!_torch)[\"']\s*,\s*[\"']cli")
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert hits == []
    src = pathlib.Path(launch.__file__).read_text()
    mods = re.findall(r"[\"'](ubresnet_tpu\w*\.cli\.\w+)", src)
    assert mods and all(m.startswith("ubresnet_tpu_torch.cli.")
                        for m in mods), mods
    for bad in ('"-m", "ubresnet_tpu.cli.train"', "-m ubresnet_tpu.cli.x",
                '"ubresnet_tpu" + ".cli.train"'):
        assert pat.search(bad), bad


def test_sources_name_no_jax_cpp():
    """No file of the port (Python, CUDA or C++) and not chip_smoke.py
    names a path under the JAX package's cpp/ directory, builds with its
    Makefile or loads a library from there: the port builds its own
    copies (cpp/rootio.cpp, cpp/uevt.cpp) with utils/native_build.py."""
    files = [p for p in PORT.rglob("*")
             if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    files.append(ROOT / "chip_smoke.py")
    pat = re.compile(r"ubresnet_tpu[\\/]+cpp"
                     r"|[\"']ubresnet_tpu[\"']\s*,\s*[\"']cpp[\"']"
                     r"|\bmake\b[\"']?\s*,\s*[\"']-C")
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.search(line)]
    assert any(p.suffix == ".cpp" for p in files) and hits == []
    # every ctypes load in the port goes through one of its builds
    loads = [f"{p.relative_to(ROOT)}:{i}" for p in files if p.suffix == ".py"
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if "CDLL(" in line and "build(" not in line]
    assert loads == [], loads


def test_host_libraries_load_from_the_ports_build():
    """Loading the port's ROOT I/O and batch filler (a fresh process)
    maps the libraries from build/host/ and nothing from the JAX
    package's cpp/."""
    code = ("from ubresnet_tpu_torch.data import native, rootio\n"
            "rootio._load(); native._load()\n"
            "print('\\n'.join(sorted({l.split()[-1] for l in "
            "open('/proc/self/maps') if l.rstrip().endswith('.so')})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    libs = proc.stdout.split()
    ours = [p for p in libs if "/build/host/lib" in p]
    assert len(ours) == 2, libs
    assert {pathlib.Path(p).name.split("-")[0] for p in ours} == {
        "librootio", "libuevt"}
    assert not [p for p in libs if "ubresnet_tpu/cpp" in p]


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


@pytest.mark.parametrize("build", ["UResNet", "ConvBN", "BasicBlock",
                                   "Deconv2x", "get_model", "TrainUResNet",
                                   "get_model_train", "ASPPResNet",
                                   "TrainASPPResNet", "ASPP", "CaffeNet"])
def test_models_default_to_cuda(monkeypatch, build):
    """A model or block built with no device asks for the card and
    raises without one; it never lands on the CPU unasked."""
    from ubresnet_tpu_torch import models
    from ubresnet_tpu_torch.deploy.weights import random_state_dict
    from ubresnet_tpu_torch.models.ssnet2018 import ssnet2018_prototxt
    from ubresnet_tpu_torch.parity.caffe import CaffeNet

    sd = random_state_dict(seed=0)
    aspp = random_state_dict(seed=0, inplanes=4, arch="aspp_resnet")
    make = {
        "UResNet": lambda: models.UResNet(sd),
        "ConvBN": lambda: models.ConvBN(sd, "conv10", "bn10"),
        "BasicBlock": lambda: models.BasicBlock(sd, "enc_layer1.res1"),
        "Deconv2x": lambda: models.Deconv2x(sd, "dec_layer1.deconv"),
        "get_model": lambda: models.get_model("uresnet", sd),
        "TrainUResNet": lambda: models.TrainUResNet(sd),
        "get_model_train": lambda: models.get_model("uresnet", sd,
                                                    train=True),
        "ASPPResNet": lambda: models.ASPPResNet(aspp),
        "TrainASPPResNet": lambda: models.TrainASPPResNet(aspp),
        "ASPP": lambda: models.ASPP(aspp, "ASPP_layer_enc3"),
        "CaffeNet": lambda: CaffeNet(ssnet2018_prototxt(inplanes=4)),
    }[build]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_kernel_shapes_have_one_table():
    """The .cu entry points instantiate and dispatch from the X-macro
    lists that _build writes from SHAPES, the table the wrappers' shape
    gates read; no source spells a shape of its own. The train zone's
    shapes (K5, K6 and K1's input gradients) are there too, and the
    gates cover every leg."""
    from ubresnet_tpu_torch.ops import _build, block, conv, deconv, train_conv

    header = _build.shapes_header()
    for name, table in (("conv_bn_act", conv.SHAPES),
                        ("basic_block", block.SHAPES),
                        ("deconv2x", deconv.SHAPES),
                        ("conv_stats", train_conv.SHAPES),
                        ("conv_dw", conv.DW_SHAPES),
                        ("conv_s2k4", deconv.S2K4_SHAPES),
                        ("deconv_dw", deconv.DW_SHAPES),
                        ("deconv2x_bwd", deconv.BWD_SHAPES)):
        macro = f"UBR_{name.upper()}_SHAPES"
        assert table is _build.SHAPES[name]
        line = next(ln for ln in header.splitlines() if macro + "(X)" in ln)
        assert line.count(" X(") == len(table)
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f"{macro}(" in src and "return launch<" in src
        assert not re.search(r"launch<\d", src)
    # the train zones at inplanes 16 (9 shapes), 32 (7, 3 shared) and at
    # 8-channel streams (8); K6 also the 3- and 4-class classifiers
    assert len(train_conv.SHAPES) == 21 and len(conv.DW_SHAPES) == 23
    assert all(train_conv.supports(*s) for s in train_conv.SHAPES)
    assert conv.ad_supports(16, 3, 7) and (4, 16, 7) in conv.SHAPES
    # every compiled upsample has its deconv-AD legs (K8, K9) too
    assert deconv.SHAPES == deconv.S2K4_SHAPES == deconv.DW_SHAPES == {
        (64, 32), (32, 16), (16, 8), (8, 4)}


@pytest.mark.parametrize("entry", ["Trainer", "build_train_step",
                                   "build_eval_step", "cli.train"])
def test_train_entry_points_default_to_cuda(monkeypatch, tmp_path, entry):
    """Training asks for the card and raises without one, unless the
    caller asks for the CPU by name."""
    from ubresnet_tpu_torch.cli.train import main
    from ubresnet_tpu_torch.core.config import TrainConfig
    from ubresnet_tpu_torch.train import build_eval_step, build_train_step
    from ubresnet_tpu_torch.train.trainer import Trainer

    cfg = tmp_path / "cfg.json"
    cfg.write_text("{}")
    make = {
        "Trainer": lambda **kw: Trainer(TrainConfig(), **kw),
        "build_train_step": lambda **kw: build_train_step(**kw),
        "build_eval_step": lambda **kw: build_eval_step(**kw),
        "cli.train": lambda **kw: main(["--config", str(cfg)]
                                       + (["--device", "cpu"] if kw else [])),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    if entry in ("build_train_step", "build_eval_step"):
        assert callable(make(device="cpu"))


def test_cli_defaults_to_cuda(monkeypatch, tmp_path):
    """No --device: the CLI asks for the card and raises without one."""
    from ubresnet_tpu_torch.cli.infer_precropped import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["-i", "in.uevt", "-o", str(tmp_path / "o.uevt"),
              "-c", "w.tar"])


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result line when
    torch sees no card (as on this host)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, cwd=ROOT,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_ptxas_log_is_read():
    """The build keeps each source's `nvcc -Xptxas -v` log; the parser
    takes every entry function's registers, spills and static shared
    memory from it (chip_smoke.py prints them in its build phase)."""
    from ubresnet_tpu_torch.ops import _build

    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z1fv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1fv\n"
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 1024 bytes "
        "smem, 388 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 388 bytes cmem[0]\n")
    assert _build.parse_ptxas(log) == [
        {"kernel": "_Z1fv", "stack_bytes": 8, "spill_stores": 8,
         "spill_loads": 4, "registers": 96, "smem_static": 1024},
        {"kernel": "_Z1gv", "stack_bytes": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 255, "smem_static": 0}]
