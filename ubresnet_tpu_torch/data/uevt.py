"""UEVT — event-addressable tensor file format.

The reference stores events in ROOT TTrees read through larcv's
IOManager (SURVEY.md §2.2/L0). ROOT deserialization of custom classes
is not portable, so the rebuild defines a simple mmap-friendly binary
container with the same capabilities: multiple named producers per
event, (run, subrun, event) ids, physical-coordinate metas, random
access by entry. The fixed-stride little-endian layout is designed for
the native C++ reader (cpp/uevt.cpp, data/native.py) to mmap and
batch-fill without any parsing beyond the index.

Layout:
  header   : magic 'UEVT' | u32 version | u64 n_entries | u64 index_off
  entries  : back-to-back event blobs; each blob is
             u32 n_images | n_images * image records
  image    : 32s producer | u32 run,subrun,event,plane
             f64 min_x,min_y,max_x,max_y | u32 rows,cols | u32 dtype
             | rows*cols*itemsize payload (row-major)
  index    : n_entries * (u64 offset | u64 nbytes | u32 run,subrun,event)
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta

MAGIC = b"UEVT"
VERSION = 1
_HEADER = struct.Struct("<4sIQQ")
_IMG_HDR = struct.Struct("<32sIIII ddddIII".replace(" ", ""))
_IDX = struct.Struct("<QQIII")

# 3 (f16) halves score-image bytes; probabilities lose ~5e-4 like
# the compact D2H path (deploy --f16-scores)
_DTYPES = {0: np.float32, 1: np.uint16, 2: np.int32, 3: np.float16}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


class EventFileWriter:
    """Sequential event writer (larcv IOManager(kWRITE) equivalent:
    deploy/run_ubresnet_precropped.py:93-95 append/set_id/save_entry)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(MAGIC, VERSION, 0, 0))
        self._index: List[Tuple[int, int, int, int, int]] = []
        self._pending: Dict[str, List[Image2D]] = {}
        self._rse = (0, 0, 0)

    def append(self, producer: str, image: Image2D):
        self._pending.setdefault(producer, []).append(image)

    def set_id(self, run: int, subrun: int, event: int):
        self._rse = (int(run), int(subrun), int(event))

    def save_entry(self):
        offset = self._f.tell()
        images = [
            (prod, img) for prod, imgs in self._pending.items() for img in imgs
        ]
        self._f.write(struct.pack("<I", len(images)))
        run, subrun, event = self._rse
        for prod, img in images:
            arr = np.ascontiguousarray(img.pixels)
            dt = _DTYPE_IDS.get(arr.dtype)
            if dt is None:
                arr = arr.astype(np.float32)
                dt = 0
            m = img.meta
            self._f.write(
                _IMG_HDR.pack(
                    prod.encode()[:32].ljust(32, b"\0"),
                    run,
                    subrun,
                    event,
                    m.plane,
                    m.min_x,
                    m.min_y,
                    m.max_x,
                    m.max_y,
                    m.rows,
                    m.cols,
                    dt,
                )
            )
            self._f.write(arr.tobytes())
        nbytes = self._f.tell() - offset
        self._index.append((offset, nbytes, run, subrun, event))
        self._pending.clear()
        self._rse = (0, 0, 0)

    def close(self):
        index_off = self._f.tell()
        for entry in self._index:
            self._f.write(_IDX.pack(*entry))
        self._f.seek(0)
        self._f.write(_HEADER.pack(MAGIC, VERSION, len(self._index), index_off))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EventFileReader:
    """Random-access event reader (larcv IOManager(kREAD) equivalent).

    Thread-safe for concurrent read_entry calls (each uses pread-style
    offsets on a shared mmap).
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._buf = np.memmap(path, dtype=np.uint8, mode="r")
        magic, version, n, index_off = _HEADER.unpack(
            self._buf[: _HEADER.size].tobytes()
        )
        if magic != MAGIC:
            raise ValueError(f"{path}: not a UEVT file")
        if version != VERSION:
            raise ValueError(f"{path}: unsupported version {version}")
        self.n_entries = n
        raw = self._buf[index_off : index_off + n * _IDX.size].tobytes()
        self._index = [
            _IDX.unpack_from(raw, i * _IDX.size) for i in range(n)
        ]

    def __len__(self):
        return self.n_entries

    def rse(self, entry: int) -> Tuple[int, int, int]:
        _, _, r, s, e = self._index[entry]
        return (r, s, e)

    def read_entry(
        self, entry: int, producers: Optional[Sequence[str]] = None
    ) -> Dict[str, List[Image2D]]:
        offset, nbytes, *_ = self._index[entry]
        blob = self._buf[offset : offset + nbytes].tobytes()
        (n_images,) = struct.unpack_from("<I", blob, 0)
        pos = 4
        out: Dict[str, List[Image2D]] = {}
        for _ in range(n_images):
            (
                prod,
                run,
                subrun,
                event,
                plane,
                min_x,
                min_y,
                max_x,
                max_y,
                rows,
                cols,
                dt,
            ) = _IMG_HDR.unpack_from(blob, pos)
            pos += _IMG_HDR.size
            dtype = _DTYPES[dt]
            nb = rows * cols * np.dtype(dtype).itemsize
            name = prod.rstrip(b"\0").decode()
            if producers is None or name in producers:
                pixels = np.frombuffer(blob, dtype, rows * cols, pos).reshape(
                    rows, cols
                )
                meta = ImageMeta(min_x, min_y, max_x, max_y, rows, cols, plane)
                out.setdefault(name, []).append(
                    Image2D(pixels.copy(), meta, run, subrun, event)
                )
            pos += nb
        return out

    def producers(self, entry: int = 0) -> List[str]:
        return sorted(self.read_entry(entry).keys())


def concat_files(paths: Sequence[str]) -> List[Tuple[EventFileReader, int]]:
    """Flatten multiple files into a list of (reader, entry) pairs —
    the reference's multi-file InputFiles lists (ubresnet_train.cfg)."""
    out = []
    for p in paths:
        r = EventFileReader(p)
        out.extend((r, i) for i in range(len(r)))
    return out
