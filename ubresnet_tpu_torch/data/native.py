"""ctypes bindings for the native (C++) UEVT reader and batch filler
(counterpart of ubresnet_tpu/data/native.py).

The port's own ``cpp/uevt.cpp``, built with g++ at first use into
``build/host/`` (utils/native_build.py), is the equivalent of larcv's
C++ ThreadProcessor stack: mmap reads and batch assembly run in
pthreads off the Python GIL. Each filler thread draws from
``mt19937_64(seed + tid)``, so with one thread and one seed it yields
the JAX package's batches. Callers fall back to the Python loader
when no toolchain exists (``native_available()``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Union

import numpy as np

from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta
from ubresnet_tpu_torch.utils import native_build

_lib = None
_lock = threading.Lock()


def _load():
    """The bound library, built on first use; raises RuntimeError
    (with the compiler's log) when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(native_build.build("uevt")))
        lib.uevt_open.restype = ctypes.c_void_p
        lib.uevt_open.argtypes = [ctypes.c_char_p]
        lib.uevt_close.argtypes = [ctypes.c_void_p]
        lib.uevt_n_entries.restype = ctypes.c_long
        lib.uevt_n_entries.argtypes = [ctypes.c_void_p]
        lib.uevt_read_image_f32.restype = ctypes.c_int
        lib.uevt_read_image_f32.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.uevt_image_dims.restype = ctypes.c_int
        lib.uevt_image_dims.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.filler_create.restype = ctypes.c_void_p
        lib.filler_create.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.c_int,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.c_uint64,
        ]
        lib.filler_next.restype = ctypes.c_int
        lib.filler_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.filler_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


class NativeEventFile:
    """mmap-backed reader (C++), API subset of EventFileReader."""

    def __init__(self, path: str):
        lib = _load()
        self._lib = lib
        self._h = lib.uevt_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path} as UEVT")
        self.path = path
        self.n_entries = lib.uevt_n_entries(self._h)

    def __len__(self):
        return self.n_entries

    def read_image(self, entry: int, producer: str, plane: int = -1):
        rows, cols = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.uevt_image_dims(
            self._h, entry, producer.encode(), plane,
            ctypes.byref(rows), ctypes.byref(cols),
        )
        if rc != 0:
            raise KeyError(f"{producer}/plane{plane} not in entry {entry}")
        buf = np.empty((rows.value, cols.value), np.float32)
        meta = np.empty(7, np.float64)
        rse = np.empty(3, np.int32)
        rc = self._lib.uevt_read_image_f32(
            self._h, entry, producer.encode(), plane,
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            meta.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            rse.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        if rc != 0:
            raise IOError("read failed")
        m = ImageMeta(meta[0], meta[1], meta[2], meta[3],
                      int(meta[4]), int(meta[5]), int(meta[6]))
        return Image2D(buf, m, int(rse[0]), int(rse[1]), int(rse[2]))

    def close(self):
        if self._h:
            self._lib.uevt_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeBatchLoader:
    """C++ threaded batch filler; API mirrors BatchLoader
    (start / [0] / getbatch / stop). ``n_entries``: the entries of all
    its files."""

    def __init__(
        self,
        paths: Union[str, Sequence[str]],
        batch_size: int = 4,
        image_producer: str = "wire",
        label_producer: str = "segment",
        weight_producer: Optional[str] = "weight",
        plane: int = -1,
        n_threads: int = 2,
        n_buffers: int = 4,
        mirror: bool = False,
        adc_threshold: float = 0.0,
        class_map: Optional[Sequence[int]] = None,
        seed: int = 0,
    ):
        if isinstance(paths, str):
            paths = [paths]
        self._lib = _load()
        self._files = [NativeEventFile(p) for p in paths]
        self.n_entries = sum(len(f) for f in self._files)
        img0 = self._files[0].read_image(0, image_producer, plane)
        self.rows, self.cols = img0.meta.rows, img0.meta.cols
        self.batch_size = batch_size
        self._params = dict(
            image_producer=image_producer,
            label_producer=label_producer,
            weight_producer=weight_producer,
            plane=plane,
            n_threads=n_threads,
            n_buffers=n_buffers,
            mirror=mirror,
            adc_threshold=adc_threshold,
            class_map=class_map,
            seed=seed,
        )
        self._h = None

    def start(self, batch_size: Optional[int] = None):
        if batch_size:
            self.batch_size = batch_size
        p = self._params
        handles = (ctypes.c_void_p * len(self._files))(
            *[f._h for f in self._files]
        )
        cm = p["class_map"]
        cm_arr = (
            np.asarray(cm, np.int32) if cm is not None else np.empty(0, np.int32)
        )
        self._h = self._lib.filler_create(
            handles,
            len(self._files),
            p["image_producer"].encode(),
            p["label_producer"].encode(),
            (p["weight_producer"] or "").encode(),
            p["plane"],
            self.batch_size,
            self.rows,
            self.cols,
            p["n_threads"],
            p["n_buffers"],
            1 if p["mirror"] else 0,
            p["adc_threshold"],
            cm_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(cm_arr),
            p["seed"],
        )
        if not self._h:
            raise RuntimeError("filler_create failed (empty files?)")
        return self

    def __getitem__(self, _ignored) -> Dict[str, np.ndarray]:
        if self._h is None:
            raise RuntimeError("call start() first")
        b, r, c = self.batch_size, self.rows, self.cols
        img = np.empty((b, r, c, 1), np.float32)
        lbl = np.empty((b, r, c), np.int32)
        wgt = np.empty((b, r, c), np.float32)
        rc = self._lib.filler_next(
            self._h,
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lbl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            wgt.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise RuntimeError("filler stopped")
        return {"image": img, "label": lbl, "weight": wgt}

    def getbatch(self, batch_size: Optional[int] = None):
        """Batch of exactly ``batch_size`` rows — reference
        ``getbatch(bs)`` semantics (training/larcv1_interface.py:47-66);
        see BatchLoader.getbatch (data/loader.py)."""
        if batch_size is None or batch_size == self.batch_size:
            return self[0]
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        parts, have = [], 0
        while have < batch_size:
            parts.append(self[0])
            have += self.batch_size
        return {
            k: np.concatenate([p[k] for p in parts])[:batch_size]
            for k in parts[0]
        }

    def __iter__(self):
        while True:
            yield self[0]

    def stop(self):
        if self._h:
            self._lib.filler_destroy(self._h)
            self._h = None
