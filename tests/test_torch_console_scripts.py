"""The port's console scripts (pyproject.toml [project.scripts],
``ubtorch-*``): one per module of ubresnet_tpu_torch/cli/ that has a
``main``, each naming a module that imports (without jax) and exposes
a callable ``main``; the JAX package's ``ubtpu-*`` entries stay its
own."""
import importlib
import pkgutil
import tomllib
from pathlib import Path

import pytest

import ubresnet_tpu_torch.cli as port_cli

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = tomllib.loads((ROOT / "pyproject.toml").read_text())[
    "project"]["scripts"]
PORT = {name: target for name, target in SCRIPTS.items()
        if name.startswith("ubtorch-")}


def _cli_modules_with_main():
    out = set()
    for info in pkgutil.iter_modules(port_cli.__path__):
        src = Path(port_cli.__path__[0], f"{info.name}.py").read_text()
        if "\ndef main(" in src:
            out.add(f"ubresnet_tpu_torch.cli.{info.name}")
    return out


def test_one_script_per_port_cli():
    assert {t.split(":")[0] for t in PORT.values()} == \
        _cli_modules_with_main()
    assert all(t.endswith(":main") for t in PORT.values())
    assert all(name.replace("ubtorch-", "ubtpu-") in SCRIPTS
               and SCRIPTS[name.replace("ubtorch-", "ubtpu-")].startswith(
                   "ubresnet_tpu.cli.") for name in PORT)


@pytest.mark.parametrize("name", sorted(PORT))
def test_script_imports_and_exposes_main(name):
    module, attr = PORT[name].split(":")
    assert module.startswith("ubresnet_tpu_torch.cli.")
    assert callable(getattr(importlib.import_module(module), attr))
    assert name == "ubtorch-" + module.rsplit(".", 1)[1].replace("_", "-")
