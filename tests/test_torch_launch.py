"""The port's launcher (cli/launch.py) against the JAX package's, and its
runs on the CPU; the cross-process build locks.

(a) With ``subprocess.Popen`` replaced in both modules by a recorder,
    the port's launcher spawns exactly JAX's commands for the same
    sweep spec and flags (a sweep's ``--job-index`` children, a job's
    training and its resumed retry, a ``--distributed`` gang's ranks
    and their UBTPU_* env) up to the module name, and ``--emit-sbatch``
    writes JAX's script up to the module name. No JAX training runs.
(b) Real runs on the CPU (``UBTPU_PLATFORM=cpu`` in the children's
    environment, as the JAX package's tests run theirs), 2-iteration
    UResNets at inplanes 4 on 32x32 events: a 2-job sweep, one job
    faulted (``fault_at_iter``, ``--retries 1``) — both exit 0, the
    faulted one resumed from its checkpoint; a ``--distributed 2`` gang
    whose rank 0 hard-exits: the launcher ends rank 1, restarts both,
    both resume; a gang whose ranks both fail (non-finite losses) exits
    1 instead of hanging in the final checkpoint's barrier. The
    children see a stub ``tensorboard`` package first on their path:
    TensorBoard is optional (train/logging.py) and importing the real
    one pulls in TensorFlow, about 10 s a process here.
(c) Two processes building at once on a fresh build directory: the
    kernel build (``nvcc`` a stub script that writes its outputs and
    logs each call) and the host build (g++ behind a wrapper that logs
    each call) each compile once, and both processes get the whole
    library.
The three runs of (b) start together (fixture ``runs``)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from ubresnet_tpu.cli import launch as jax_launch
from ubresnet_tpu_torch.cli import launch as port_launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Recorder:
    """Stands in for subprocess.Popen: records (cmd, UBTPU_* env) and
    exits with the next code of ``codes`` (0 when they run out)."""

    def __init__(self, codes=()):
        self.calls, self.codes = [], list(codes)
        outer = self

        class Proc:
            pid = 1

            def __init__(self, cmd, env=None, **_):
                e = env or {}
                outer.calls.append((list(cmd), {k: v for k, v in e.items()
                                                if k.startswith("UBTPU_")}))
                self.code = outer.codes.pop(0) if outer.codes else 0

            def wait(self):
                return self.code

            def poll(self):
                return self.code

            def terminate(self):
                pass

        self.Proc = Proc


def _spawned(module, monkeypatch, codes, fn):
    rec = Recorder(codes)
    monkeypatch.setattr(module.subprocess, "Popen", rec.Proc)
    monkeypatch.setattr(module.time, "sleep", lambda s: None)
    return fn(), rec.calls


def _ported(calls):
    """JAX's commands with its module names in the port's package."""
    return [([a.replace("ubresnet_tpu.cli.", "ubresnet_tpu_torch.cli.")
              for a in cmd], env) for cmd, env in calls]


def _sweep(tmp_path):
    sweep = {"base": str(tmp_path / "cfg.json"), "stagger_seconds": 2,
             "max_restarts": 1,
             "jobs": [{"name": "plane0", "set": {"train_data.plane": 0}},
                      {"set": {"optim.lr": 1e-4, "max_restarts": 0}}]}
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(sweep))
    return sweep, str(path)


@pytest.mark.parametrize("case", ["sweep", "job", "job_retry",
                                  "distributed"])
def test_spawned_commands_equal_jax(tmp_path, monkeypatch, case):
    sweep, spath = _sweep(tmp_path)
    work = str(tmp_path / "w")
    runs = {
        "sweep": (lambda m: m.main(["--sweep", spath, "--workdir", work,
                                    "--parallel", "2", "--retries", "1"]),
                  ()),
        "job": (lambda m: m.run_job(sweep, 1, work), (1,)),
        "job_retry": (lambda m: m.run_job(sweep, 0, work), (1, 0)),
        "distributed": (lambda m: m.main(
            ["--distributed", "2", "--config", spath, "--coordinator",
             "127.0.0.1:29411", "--workdir", work, "--set", "seed=3",
             "--retries", "1"]), (0, 1, 0, 0)),
    }
    fn, codes = runs[case]
    want_rc, want = _spawned(jax_launch, monkeypatch, codes,
                             lambda: fn(jax_launch))
    got_rc, got = _spawned(port_launch, monkeypatch, codes,
                           lambda: fn(port_launch))
    assert got_rc == want_rc and got == _ported(want) and got
    mods = [c[c.index("-m") + 1] for c, _ in got]
    assert all(m.startswith("ubresnet_tpu_torch.cli.") for m in mods), mods


def test_emit_sbatch_equals_jax(tmp_path):
    sweep, spath = _sweep(tmp_path)
    a = jax_launch.emit_sbatch(spath, sweep, str(tmp_path / "jax.sh"))
    b = port_launch.emit_sbatch(spath, sweep, str(tmp_path / "port.sh"))
    want = open(a).read().replace("ubresnet_tpu.cli.",
                                  "ubresnet_tpu_torch.cli.")
    assert open(b).read() == want and "ubresnet_tpu_torch.cli.launch" in want
    assert os.access(b, os.X_OK)
    assert port_launch.main(["--sweep", spath, "--emit-sbatch",
                             str(tmp_path / "cli.sh")]) == 0
    assert open(tmp_path / "cli.sh").read() == want


def _config(tmp_path, **extra):
    from ubresnet_tpu_torch.data.synthetic import make_synthetic_file

    tmp_path.mkdir(parents=True, exist_ok=True)
    data = make_synthetic_file(str(tmp_path / "d.uevt"), n_events=8,
                               hw=(32, 32))
    cfg = {"model": {"inplanes": 4, "precision": "f32"},
           "train_data": {"files": [data], "batch_size": 2, "n_threads": 1,
                          "native": False},
           "num_iters": 2, "checkpoint_every": 1, "print_every": 1,
           "seed": 1}
    cfg.update(extra)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three CPU runs of (b), started together (each a chain of
    processes that mostly waits on its own start-up): {name: (the
    launcher's Popen, its directory)}. The children see the CPU, one
    thread each, and the repo on their path behind a stub tensorboard
    package."""
    top = tmp_path_factory.mktemp("runs")
    (top / "stub" / "tensorboard").mkdir(parents=True)
    (top / "stub" / "tensorboard" / "__init__.py").write_text("")
    env = dict(os.environ, UBTPU_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(top / "stub"), ROOT,
                    os.environ.get("PYTHONPATH", "")]))
    d = top / "sweep"
    sweep = {"base": _config(d), "jobs": [
        {"name": "ok", "set": {"seed": 2}},
        {"name": "flaky", "set": {"fault_at_iter": 1}}]}
    (d / "sweep.json").write_text(json.dumps(sweep))
    args = {"sweep": (d, ["--sweep", str(d / "sweep.json"), "--workdir",
                          str(d / "w"), "--parallel", "2", "--retries",
                          "1"])}
    d = top / "gang"
    args["gang"] = (d, ["--distributed", "2", "--config",
                        _config(d, checkpoint_dir=str(d / "ck")),
                        "--workdir", str(d / "g"), "--retries", "1",
                        "--set", "fault_at_iter=1"])
    d = top / "failed"
    args["failed"] = (d, ["--distributed", "2", "--config", _config(
        d, checkpoint_dir=str(d / "ck"), num_iters=4, max_nan_recoveries=0,
        optim={"name": "adam", "lr": 1e30}), "--workdir", str(d / "g")])
    procs = {name: (subprocess.Popen(
        [sys.executable, "-m", "ubresnet_tpu_torch.cli.launch", *a],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=d), d) for name, (d, a) in args.items()}
    yield procs
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _result(runs, name, timeout=180):
    proc, d = runs[name]
    out, _ = proc.communicate(timeout=timeout)
    return proc.returncode, out, d


def test_sweep_with_a_faulted_job_resumes(runs):
    rc, out, d = _result(runs, "sweep")
    assert rc == 0, out
    assert "sweep done: exit codes [0, 0]" in out
    flaky = (d / "w" / "flaky" / "train.log").read_text()
    assert "fault injection: hard exit after iter 1" in flaky
    assert "resumed from iter 1" in flaky
    # a child put on the CPU by the inherited switch says so
    assert "device: cpu (UBTPU_PLATFORM=cpu)" in flaky
    assert "restarting with resume" in (
        d / "w" / "flaky" / "launch.log").read_text()
    for job in ("ok", "flaky"):
        ck = d / "w" / job / "checkpoints"
        assert (ck / "step_00000002.tar").exists(), job
        assert (d / "w" / job / "logs" / "run.jsonl").exists()


def test_distributed_gang_restarts_and_resumes(runs):
    rc, out, d = _result(runs, "gang")
    assert rc == 0, out
    assert "terminating the rest of the gang" in out
    assert "restarting all 2 processes with resume" in out
    logs = [(d / "g" / f"proc{r}.log").read_text() for r in (0, 1)]
    assert "fault injection: hard exit after iter 1" in logs[0]
    for r, log in enumerate(logs):
        assert f"distributed: process {r}/2, backend gloo, device cpu" in log
        assert "resumed from iter 1" in log
    assert (d / "ck" / "step_00000002.tar").exists()


def test_failed_gang_exits_instead_of_hanging(runs):
    """Both ranks meet non-finite losses (lr 1e30) and stop at the same
    iteration; each leaves without the final checkpoint's barrier (rank
    0 still writes it) and the launcher returns 1."""
    rc, out, d = _result(runs, "failed", timeout=120)
    assert rc == 1, out
    logs = [(d / "g" / f"proc{r}.log").read_text() for r in (0, 1)]
    assert all("FloatingPointError" in log for log in logs)
    assert any(p.name.startswith("step_") for p in (d / "ck").iterdir())


NVCC_STUB = """#!/bin/sh
# writes what nvcc would (-o TARGET) and logs the call
echo "$@" >> "$NVCC_LOG"
sleep 0.2
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then printf 'built %s\\n' "$2" > "$2"; fi
  shift
done
"""

BUILD_BOTH = textwrap.dedent("""
    import sys
    from pathlib import Path
    from ubresnet_tpu_torch.ops import _build
    from ubresnet_tpu_torch.utils import native_build
    native_build.CPP = Path(sys.argv[1])
    native_build.LIBS = {"tiny": ()}
    print(_build.build().read_text().strip())
    print(native_build.build("tiny"))
""")


def test_concurrent_builds_build_once(tmp_path):
    """Two processes at once on a fresh checkout's build directories:
    one nvcc link and one g++ run, and both see the finished files."""
    import ctypes
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(NVCC_STUB)
    nvcc.chmod(0o755)
    gxx = bin_dir / "gxx"
    gxx.write_text('#!/bin/sh\necho "$@" >> "$GXX_LOG"\nexec g++ "$@"\n')
    gxx.chmod(0o755)
    cpp = tmp_path / "src" / "cpp"
    cpp.mkdir(parents=True)
    (cpp / "tiny.cpp").write_text('extern "C" int tiny() { return 7; }\n')
    env = dict(os.environ, PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
               NVCC_LOG=str(tmp_path / "nvcc.log"),
               GXX_LOG=str(tmp_path / "gxx.log"), CXX=str(gxx),
               UBRESNET_TORCH_BUILD=str(tmp_path / "kernels"),
               PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_BOTH, str(cpp)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lib = tmp_path / "kernels" / "libubresnet_kernels.so"
    lines = [o.strip().splitlines() for o, _ in outs]
    assert lines[0] == lines[1] and lines[0][0].startswith("built ")
    assert lib.read_text().strip() == lines[0][0]
    calls = (tmp_path / "nvcc.log").read_text().splitlines()
    links = [c for c in calls if "-shared" in c]
    n_src = len(list((tmp_path / "kernels").glob("*.o")))
    assert len(links) == 1 and len(calls) == n_src + 1, calls
    assert (tmp_path / "gxx.log").read_text().count("tiny.cpp") == 1
    assert ctypes.CDLL(lines[0][1]).tiny() == 7
