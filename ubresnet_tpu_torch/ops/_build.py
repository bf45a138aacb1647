"""Build and bind the Hopper kernels (ops/csrc/*.cu).

Each source compiles with its own ``nvcc -c`` for ``sm_90a``, all
started together, and the objects link into one shared library with a
plain C interface, ``build/kernels/libubresnet_kernels.so`` under the
checkout (``UBRESNET_TORCH_BUILD`` overrides the directory). The
library is loaded with ctypes; every entry point takes its pointers
and the stream as ``c_void_p`` (a bare int would be cut to 32 bits)
and returns ``cudaGetLastError()`` after its launch, which ``launch``
turns into an exception.

``SHAPES`` is the one table of the shapes each kernel is compiled for:
the build writes it as X-macro lists into ``ubr_shapes.h`` beside the
objects, the ``.cu`` entry points instantiate and dispatch from those
lists, and the wrappers' ``supports()`` / ``s8_supports()`` gates read
the same table.

The deconv's backward (K8 ``ubr_conv_s2k4``, K9 ``ubr_deconv_dw`` and
K10 ``ubr_deconv2x_bwd``, both legs in one launch) takes the deconv's
own (ci, co) and its input-side H, W; dy is (B, 2H, 2W, co).

The int8 entry points (K1-s8, K2-s8, K3-s8: ``ubr_conv_bn_act_s8``,
``ubr_basic_block_s8``, ``ubr_deconv2x_s8``) take int8 activations and
int8 weights in the same layouts and argument order as their bf16
counterparts, f32 affines that carry the dequant scales, and one more
int before the stream, ``out_f32``: 1 writes a float32 output (and
reads a float32 residual), 0 bf16. K2-s8 always takes ``gb``/``bb``:
with the identity bypass (``wb`` NULL) they dequantize the int8 input
(gb = sx, bb = 0).

Each compile runs with ``-Xptxas -v`` and keeps its log beside its
object (``<source>.log``); ``ptxas_report`` reads every kernel's
registers, spills and static shared memory from those logs.

Nothing here runs at import: the first kernel launch builds (or finds
an up-to-date build, keyed by a hash of the sources) and loads the
library. A build holds an exclusive ``fcntl`` lock on
``<build dir>/.build.lock`` from its stamp check to its stamp, so
processes that start on a fresh checkout at once (the ranks of one
training, the jobs of a sweep) build once: the others wait, then find
the stamp. A CPU-only host may have no nvcc at all; the CPU path never calls
in here.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
LIB_NAME = "libubresnet_kernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point → argtypes (pointers and the trailing stream are void*)
SIGNATURES = {
    # x, w, g, b, residual, out | B, H, W, ci, co, k, pre_act, act | stream
    "ubr_conv_bn_act": [_P] * 6 + [_I] * 8 + [_P],
    # a, b, w1, g1, b1, w2, g2, b2, wb, gb, bb, wf, out | B, H, W, ca,
    # cb, co (wf: the streamed form's weight-fragment scratch)
    "ubr_basic_block": [_P] * 13 + [_I] * 6 + [_P],
    # x, w, out | B, H, W, ci, co
    "ubr_deconv2x": [_P] * 3 + [_I] * 5 + [_P],
    # x, out | B, H, W, C
    "ubr_maxpool3x3s2": [_P] * 2 + [_I] * 4 + [_P],
    # x, w, bias, y, partials, sums | B, H, W, ci, co, k, blocks
    "ubr_conv_stats": [_P] * 6 + [_I] * 7 + [_P],
    # x, dy, partials, dw | B, H, W, ci, co, k, rows
    "ubr_conv_dw": [_P] * 4 + [_I] * 7 + [_P],
    # out[6] | B, H, W, ci, co, k, rows (no stream: K6's launch geometry)
    "ubr_conv_dw_grid": [_P] + [_I] * 7,
    # logits, labels, weights, partials, loss | N, C, blocks | N as float
    "ubr_weighted_nll": [_P] * 5 + [_I] * 3 + [_F, _P],
    # logits, labels, weights, g, grad | N, C | N as float
    "ubr_weighted_nll_bwd": [_P] * 5 + [_I] * 2 + [_F, _P],
    # int8 (s8 x s8 -> s32; out_f32: float output instead of bf16)
    # xq, wq, g, b, residual, out | B, H, W, ci, co, k, pre_act, act,
    # out_f32
    "ubr_conv_bn_act_s8": [_P] * 6 + [_I] * 9 + [_P],
    # aq, bq, w1q, g1, b1, w2q, g2, b2, wbq, gb, bb, wf, out | B, H, W,
    # ca, cb, co, out_f32
    "ubr_basic_block_s8": [_P] * 13 + [_I] * 7 + [_P],
    # xq, wq, g, out | B, H, W, ci, co, out_f32
    "ubr_deconv2x_s8": [_P] * 4 + [_I] * 6 + [_P],
    # the deconv's backward (H, W: the deconv's input side)
    # dy, w, dx | B, H, W, ci, co
    "ubr_conv_s2k4": [_P] * 3 + [_I] * 5 + [_P],
    # x, dy, partials, dw | B, H, W, ci, co, blocks
    "ubr_deconv_dw": [_P] * 4 + [_I] * 6 + [_P],
    # x, dy, w, dx, partials, counter, dw | B, H, W, ci, co, rows
    "ubr_deconv2x_bwd": [_P] * 7 + [_I] * 6 + [_P],
}

# The train zone's convolutions (stride 1), as (ci, co, k): the enc1,
# dec2 and dec1 BasicBlocks (3x3 convs and 1x1 projections) and the
# head conv10 where the JAX package fuses them (models/blocks.py:
# conv_ad_fuses). K5 runs their forward and K6 their weight gradient;
# K1 runs their input gradient at the transposed shape (co, ci, k).
# Inplanes 16 (the flagship):
_TRAIN_ZONE_16 = {(16, 32, 3), (16, 32, 1), (32, 32, 3), (64, 32, 3),
                  (64, 32, 1), (32, 16, 3), (32, 16, 1), (16, 16, 3),
                  (16, 16, 7)}
# inplanes 32 (the reference trainer's UResNet): enc1 (32 -> 64), dec2
# over its 128-channel concat (the first conv stays off: 2·128 > 128),
# dec1; the head conv10 (32, 16, 7) stays off (2·3·32 > 128)
_TRAIN_ZONE_32 = {(32, 64, 3), (32, 64, 1), (64, 64, 3), (128, 64, 1),
                  (64, 32, 3), (64, 32, 1), (32, 32, 3)}
# 8-channel streams (inplanes 8 and 4): the enc1, dec2 and dec1 convs
# and the head conv10 whose lanes JAX's gate passes (at 4, enc1.res1's
# conv1 (4, 8, 3) and its projection fail it: 4 channels at pack 16
# fill 64 lanes)
_TRAIN_ZONE_8 = {(8, 16, 3), (8, 16, 1), (8, 16, 7), (16, 8, 3),
                 (16, 8, 1), (8, 8, 3), (8, 4, 3), (8, 4, 1)}
_TRAIN_ZONE = _TRAIN_ZONE_16 | _TRAIN_ZONE_32 | _TRAIN_ZONE_8
# the classifier conv11, 3 classes and the 4-class deploy model's
_CLASSIFIERS = {(16, 3, 7), (16, 4, 7)}
# (ca, cb, co, projection) of the eval model's BasicBlocks in the zone
_BLOCKS = frozenset({
    (16, 0, 32, True),    # enc1.res1
    (32, 0, 32, False),   # enc1.res2, dec2.res.res2; dec1.res.res2 at 32
    (32, 32, 32, True),   # dec2.res.res1; dec1.res.res1 at 32
    (16, 16, 16, True),   # dec1.res.res1
    (16, 0, 16, False),   # dec1.res.res2
    # inplanes 32
    (32, 0, 64, True),    # enc1.res1
    (64, 0, 64, False),   # enc1.res2, dec2.res.res2 (streamed weights)
    (64, 64, 64, True),   # dec2.res.res1 (streamed weights)
    # 8-channel streams: inplanes 8 (at 4, enc1.res1 and dec1's blocks
    # run per conv; enc1.res2 and dec2's take the last two)
    (8, 0, 16, True),     # enc1.res1
    (8, 8, 8, True),      # dec1.res.res1; dec2.res.res1 at 4
    (8, 0, 8, False),     # dec1.res.res2; enc1.res2, dec2.res.res2 at 4
})
# (ci, co): dec2 and dec1 upsamples (dec1's at inplanes 32 is (64, 32);
# dec2's there, (128, 64), stays off: 2·128 > 128); at inplanes 8 dec2
# (32, 16) and dec1 (16, 8), at 4 dec2 (16, 8) and dec1 (8, 4)
_DECONVS = frozenset({(64, 32), (32, 16), (16, 8), (8, 4)})
# the convs JAX fuses at 8-channel streams outside the blocks: the head
# conv10 at inplanes 8; at 4 the per-conv blocks' convs whose lanes pass,
# enc1.res1's cb2 and dec1.res.res1's cb1 and projection
_CONVS_8 = {(8, 16, 7), (8, 8, 3), (8, 4, 3), (8, 4, 1)}

# kernel → the template arguments instantiated in its .cu entry point,
# the kernel-zone layers of the UResNets the port runs (inplanes 16, 32,
# 8 and 4, 3 or 4 classes; ASPP-ResNet's are among them)
SHAPES = {
    # (ci, co, k): head conv10 and the classifiers (eval, and the
    # classifier's train forward); the input gradients of the train
    # zone and of the classifiers, whose 3 or 4 channels K1 reads
    # zero-padded to 4
    "conv_bn_act": frozenset({(16, 16, 7), (4, 16, 7)} | _CLASSIFIERS
                             | _CONVS_8
                             | {(-(-co // 4) * 4, ci, k)
                                for ci, co, k in _TRAIN_ZONE}),
    # (ci, co, k): the train zone's forward
    "conv_stats": frozenset(_TRAIN_ZONE),
    # (ci, co, k): the train zone's and the classifiers' weight gradient
    "conv_dw": frozenset(_TRAIN_ZONE | _CLASSIFIERS),
    # (ca, cb, co, projection); cb == 0 is the single-stream block
    "basic_block": _BLOCKS,
    "deconv2x": _DECONVS,
    # (ci, co) of the deconv: its input gradient (K8) and weight
    # gradient (K9), and both in one launch (K10, the backward of
    # deconv2x_ad under Policy.fused_train_deconv)
    "conv_s2k4": _DECONVS,
    "deconv_dw": _DECONVS,
    "deconv2x_bwd": _DECONVS,
    # int8 deploy (Policy.int8): the head conv10 and the 8-channel
    # convs on K1-s8 where JAX fuses them (the 1-channel stem is an
    # exact plain-torch integer conv, as XLA in JAX; the classifier
    # stays bf16 K1), the same blocks on K2-s8, the same upsamples on
    # K3-s8
    "conv_bn_act_s8": frozenset({(16, 16, 7)} | _CONVS_8),
    "basic_block_s8": _BLOCKS,
    "deconv2x_s8": _DECONVS,
}
SHAPES_HEADER = "ubr_shapes.h"

_lock = threading.Lock()
_lib = None


def build_dir() -> Path:
    env = os.environ.get("UBRESNET_TORCH_BUILD")
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "kernels"


def _sources():
    return sorted(CSRC.glob("*.cu"))


def shapes_header() -> str:
    """``#define UBR_<KERNEL>_SHAPES(X) X(a, b, ...) ...`` per kernel."""
    def arg(v):
        return ("true" if v else "false") if isinstance(v, bool) else str(v)

    lines = ["// Written by ubresnet_tpu_torch/ops/_build.py from its SHAPES.",
             "#pragma once"]
    for name, shapes in SHAPES.items():
        calls = " ".join(f"X({', '.join(map(arg, s))})"
                         for s in sorted(shapes))
        lines.append(f"#define UBR_{name.upper()}_SHAPES(X) {calls}")
    return "\n".join(lines) + "\n"


def _source_hash() -> str:
    h = hashlib.sha256(ARCH.encode())
    h.update(shapes_header().encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the Hopper kernels are built with "
                       "the CUDA toolkit (PATH or /usr/local/cuda/bin)")


@contextlib.contextmanager
def file_lock(path: Path):
    """An exclusive ``fcntl`` lock on ``path`` (created if missing),
    held for the block: serialises builds across processes."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> Path:
    """Compile every csrc/*.cu in parallel and link the shared library;
    a build whose stamp matches the sources' hash is reused. Returns
    the library path. Runs under the build directory's file lock."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    with file_lock(out / ".build.lock"):
        return _build_locked(out)


def _build_locked(out: Path) -> Path:
    lib = out / LIB_NAME
    stamp = out / (LIB_NAME + ".stamp")
    key = _source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == key:
        return lib
    nvcc = _nvcc()
    header = out / (SHAPES_HEADER + f".{os.getpid()}.tmp")
    header.write_text(shapes_header())
    os.replace(header, out / SHAPES_HEADER)
    flags = [ARCH, "-std=c++17", "-O3", "-Xptxas", "-v", "-Xcompiler",
             "-fPIC", "-I", str(CSRC), "-I", str(out)]
    procs = []
    for src in _sources():
        obj = out / (src.stem + ".o")
        cmd = [nvcc, *flags, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, _, proc in procs:  # wait for every compile, even on failure
        log, _ = proc.communicate()
        (out / (src.stem + ".log")).write_text(log)
        if proc.returncode:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
    if errors:
        raise RuntimeError("\n".join(errors))
    tmp = out / (LIB_NAME + f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp),
         *[str(obj) for _, obj, _ in procs], "-lcudart"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp.write_text(key)
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ubr_error_string.argtypes = [ctypes.c_int]
            lib.ubr_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch(name: str, tensors, ints, device: torch.device):
    """Call entry point ``name`` with tensor pointers (None → NULL),
    scalar arguments (ints; floats stay floats) and the current stream
    of ``device``; raise on a non-zero cudaGetLastError()."""
    lib = _lib or library()
    stream = torch.cuda.current_stream(device).cuda_stream
    scalars = [v if isinstance(v, float) else int(v) for v in ints]
    # switch devices only where the current one is another
    here = device.index in (None, torch.cuda.current_device())
    with contextlib.nullcontext() if here else torch.cuda.device(device):
        rc = getattr(lib, name)(*[_ptr(t) for t in tensors], *scalars,
                                stream)
    if rc:
        msg = lib.ubr_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def _demangle(names):
    tool = next((t for t in (shutil.which("cu++filt"),
                             "/usr/local/cuda/bin/cu++filt",
                             shutil.which("c++filt"))
                 if t and os.path.exists(t)), None)
    if tool is None:
        return list(names)
    run = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True)
    lines = run.stdout.splitlines()
    return lines if run.returncode == 0 and len(lines) == len(names) \
        else list(names)


def parse_ptxas(log: str) -> list:
    """[{kernel (mangled), registers, spill_stores, spill_loads,
    stack_bytes, smem_static}] from one ``nvcc -Xptxas -v`` log."""
    out = []
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            out.append({"kernel": m.group(1)})
            continue
        if not out:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[-1].update(stack_bytes=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = _PTXAS_USED.search(line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            s = _PTXAS_SMEM.search(line)
            out[-1]["smem_static"] = int(s.group(1)) if s else 0
    return out


def ptxas_report() -> list:
    """Every kernel's ptxas figures from the build's compile logs, with
    its source and demangled name."""
    rows = []
    for src in _sources():
        log = build_dir() / (src.stem + ".log")
        if log.exists():
            rows += [{"source": src.name, **r}
                     for r in parse_ptxas(log.read_text())]
    for r, name in zip(rows, _demangle([r["kernel"] for r in rows])):
        cut = name.find(">(")  # the template, not the argument list
        r["kernel"] = name[:cut + 1] if cut >= 0 else name
    return rows


def out_f32(dtype) -> int:
    """The int8 entry points' ``out_f32`` flag for an output dtype."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"int8 kernels write bfloat16 or float32, not {dtype}")
    return int(dtype == torch.float32)


def check_aligned(t, name: str) -> None:
    """Raise unless ``t``'s data starts on a 16-byte boundary (the
    tensor-core kernels copy activations in 16-byte chunks)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
