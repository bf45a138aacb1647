"""What every run shares: finding a cell's files by name, seeds, the
device line, the check for JAX in the process, and the result line.

Files are found by the names ``BENCHMARK.json`` gives: a cell is
``cells/<workload>.json`` (its configuration, its traffic mix and the
limits of its comparison), a configuration ``configs/<name>.json``, a
traffic mix ``traffic/<name>.json``, the work of a configuration's
kernel-zone layers ``work/<config>.json``, the plain reference of a
configuration's ``arch`` ``reference/<arch>.py`` (which also gives its
weights' layout and its FLOPs), a traffic kind's code
``kinds/<kind>.py``, a per-layer metric ``metrics/<metric>.py`` and a
kernel's name map ``kernels/<kernel>.json``. A later cell, mix,
configuration, architecture, metric or kernel is a new file.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

# top-level module names that may not be loaded in a run's process: JAX,
# its libraries and the JAX package (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ubresnet_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """A workload as a run needs it: its entry in BENCHMARK.json, its
    cell file, configuration, traffic mix and zone work."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    work: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files; KeyError when
    BENCHMARK.json has no such workload."""
    bench = bench or benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    cell = load_json(BENCH_DIR / "cells" / f"{name}.json")
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"cells/{name}.json names {cell['config']} / "
                         f"{cell['traffic']}, BENCHMARK.json "
                         f"{entry['config']} / {entry['traffic']}")
    # an end-to-end metric without ``workloads`` is every cell's; a
    # per-layer metric names its cells
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Cell(name=name, chips=entry["chips"],
                config=load_json(BENCH_DIR / "configs"
                                 / f"{entry['config']}.json"),
                traffic=load_json(BENCH_DIR / "traffic"
                                  / f"{entry['traffic']}.json"),
                limits=cell["limits"],
                work=load_json(BENCH_DIR / "work" / f"{entry['config']}.json"),
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path):
    """Import a file by its path (metric and kind files carry dots and
    are found by name)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    return load_module(BENCH_DIR / "kinds" / f"{kind}.py")


def reference_module(cfg: dict):
    """The plain reference of the configuration ``cfg``: the module
    ``reference/<arch>.py`` (the contract every such module keeps:
    reference/shared.py says where it is written)."""
    path = BENCH_DIR / "reference" / f"{cfg['arch']}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"configuration {cfg.get('name')!r} names arch {cfg['arch']!r}, "
            f"and there is no {path.relative_to(ROOT)}")
    return load_module(path)


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 32-bit seeds from any whole number."""
    return [int(s) for s in
            np.random.SeedSequence(seed % (1 << 64)).generate_state(n)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def pin_caches() -> None:
    """Every build and kernel cache inside the checkout at fixed paths,
    so only a checkout's first run builds: the port's kernel library
    (``UBRESNET_TORCH_BUILD``, its own default) and, should anything
    compile through them, torch's extension and Triton caches."""
    build = ROOT / "build"
    os.environ["UBRESNET_TORCH_BUILD"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def quiet_host() -> None:
    """Just before a window: collect garbage, then leave what set-up made
    out of later collections, so none walks the program's objects."""
    gc.collect()
    gc.freeze()


def quiet_rate(calls: int, since, until: float) -> dict:
    """The calls made after the traced stretches and their seconds, on
    the host's clock (the rate behind ``mfu``)."""
    return {"calls": calls,
            "seconds": until - since if since is not None else 0.0}


def quantile(values, q: float) -> float:
    """Linear-interpolated quantile (numpy's default) of ``values``."""
    return float(np.percentile(np.asarray(values, np.float64), 100 * q))


def setup_line(t_start: float, marks) -> str:
    """Set-up's seconds by phase: [(phase, perf_counter at its end)]."""
    parts, t = [], t_start
    for name, at in marks:
        parts.append(f"{name} {at - t:.2f}")
        t = at
    return "set-up s: " + ", ".join(parts)


def device_line(torch, dev, peak_bytes: int, count: int = 1) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them (printed
    beside the shares of peak, which assume 700 W)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"
