"""Build the port's host libraries (``cpp/rootio.cpp``, ``cpp/uevt.cpp``)
with g++ at first use.

Each library lands in ``build/host/`` under the checkout as
``lib<name>-<hash>.so``, where the hash covers the compiler command and
the source, so an edited source builds anew and an unchanged one is
reused. A build runs under an exclusive ``fcntl`` lock on
``build/host/.<name>.lock`` (and a thread lock), checking for the
library inside it, so processes that start at once (test workers, the
ranks of a training, sweep jobs) compile once; it writes a temporary
file and renames it into place, so nothing loads a half-written
library. A failed build raises with the compiler's log.

``rootio`` links zlib and loads zstd, lz4 and lzma with dlopen at their
first basket (cpp/rootio.cpp); ``uevt`` needs nothing but pthreads.
Nothing here runs at import.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ubresnet_tpu_torch.ops._build import file_lock

CPP = Path(__file__).resolve().parents[1] / "cpp"
# no -march=native: a build directory may be copied to another host
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread",
         "-shared")
LIBS = {"rootio": ("-lz", "-ldl"), "uevt": ()}

_lock = threading.Lock()


def build_dir() -> Path:
    return CPP.parents[1] / "build" / "host"


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's host libraries "
                           "(cpp/rootio.cpp, cpp/uevt.cpp) build with it")
    return cxx


def _command(name: str, out: Path):
    return [compiler(), *FLAGS, "-o", str(out), str(CPP / f"{name}.cpp"),
            *LIBS[name]]


def library_path(name: str) -> Path:
    """Where ``name``'s library for the current source lives."""
    h = hashlib.sha256(" ".join(_command(name, Path("lib"))).encode())
    h.update((CPP / f"{name}.cpp").read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Build (or find built) ``lib<name>`` and return its path."""
    if name not in LIBS:
        raise ValueError(f"unknown host library {name!r}")
    lib = library_path(name)
    lib.parent.mkdir(parents=True, exist_ok=True)
    with _lock, file_lock(lib.parent / f".{name}.lock"):
        if lib.exists():
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(_command(name, tmp), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=300)
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on cpp/{name}.cpp:\n"
                               f"{proc.stdout}")
        os.replace(tmp, lib)
        return lib
