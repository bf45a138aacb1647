"""larcv ROOT files in and out (counterpart of
ubresnet_tpu/data/rootio.py): ctypes bindings for the port's own
``cpp/rootio.cpp``, built with g++ at first use into ``build/host/``
(utils/native_build.py).

Replaces the reference's PyROOT/larcv read path (larcv::IOManager kREAD
over image2d trees, /root/reference/deploy/run_ubresnet_precropped.py:83-95)
and its write-back (IOManager kWRITE of the ``uburn_plane%d``
producers). The C++ layer walks the ROOT container format (TKey scan,
zlib/zstd/lz4/lzma baskets, per-entry offsets) and decodes larcv
EventImage2D payloads in all three storage layouts — object-wise
streamed, member-wise streamed (kStreamedMemberWise), and split trees
(per-member leaf branches reassembled through the parent branch
name) — tolerating both larcv generations' dictionary layouts. zlib is
linked; zstd, lz4 and lzma load with dlopen, and a basket whose codec
library is absent raises naming the codec (``codecs()`` says which
loaded). The writer embeds no time stamp, so the same images give the
same bytes as the JAX package's writer.

Unrecognised layouts get precise diagnostics (see ``inspect_file``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

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
        lib = ctypes.CDLL(str(native_build.build("rootio")))
        c = ctypes
        lib.rootio_codecs.restype = c.c_int
        lib.rootio_codecs.argtypes = [c.c_char_p, c.c_int]
        lib.rootio_open.restype = c.c_void_p
        lib.rootio_open.argtypes = [c.c_char_p]
        lib.rootio_error.restype = c.c_char_p
        lib.rootio_error.argtypes = [c.c_void_p]
        lib.rootio_close.argtypes = [c.c_void_p]
        lib.rootio_n_branches.restype = c.c_long
        lib.rootio_n_branches.argtypes = [c.c_void_p]
        lib.rootio_branch_info.restype = c.c_int
        lib.rootio_branch_info.argtypes = [
            c.c_void_p, c.c_long, c.c_char_p, c.c_int, c.c_char_p, c.c_int,
            c.POINTER(c.c_long), c.POINTER(c.c_long),
        ]
        lib.rootio_n_keys.restype = c.c_long
        lib.rootio_n_keys.argtypes = [c.c_void_p]
        lib.rootio_key_info.restype = c.c_int
        lib.rootio_key_info.argtypes = [
            c.c_void_p, c.c_long, c.c_char_p, c.c_int, c.c_char_p, c.c_int,
            c.c_char_p, c.c_int, c.POINTER(c.c_long), c.POINTER(c.c_long),
            c.POINTER(c.c_long),
        ]
        lib.rootio_entry_size.restype = c.c_long
        lib.rootio_entry_size.argtypes = [
            c.c_void_p, c.c_char_p, c.c_char_p, c.c_long,
        ]
        lib.rootio_read_raw.restype = c.c_long
        lib.rootio_read_raw.argtypes = [
            c.c_void_p, c.c_char_p, c.c_char_p, c.c_long,
            c.POINTER(c.c_uint8), c.c_long,
        ]
        lib.rootio_event_info.restype = c.c_int
        lib.rootio_event_info.argtypes = [
            c.c_void_p, c.c_char_p, c.c_char_p, c.c_long,
            c.POINTER(c.c_long), c.POINTER(c.c_long),
        ]
        lib.rootio_image_meta.restype = c.c_int
        lib.rootio_image_meta.argtypes = [
            c.c_void_p, c.c_char_p, c.c_char_p, c.c_long, c.c_int,
            c.POINTER(c.c_double),
        ]
        lib.rootio_image_pixels.restype = c.c_long
        lib.rootio_image_pixels.argtypes = [
            c.c_void_p, c.c_char_p, c.c_char_p, c.c_long, c.c_int,
            c.POINTER(c.c_float), c.c_long,
        ]
        lib.rootw_open.restype = c.c_void_p
        lib.rootw_open.argtypes = [c.c_char_p, c.c_int, c.c_int]
        lib.rootw_error.restype = c.c_char_p
        lib.rootw_error.argtypes = [c.c_void_p]
        lib.rootw_write_entry.restype = c.c_int
        lib.rootw_write_entry.argtypes = [
            c.c_void_p, c.c_char_p, c.POINTER(c.c_long), c.c_long,
            c.POINTER(c.c_long), c.POINTER(c.c_long), c.POINTER(c.c_long),
            c.POINTER(c.c_double), c.POINTER(c.c_float),
        ]
        lib.rootw_close.restype = c.c_int
        lib.rootw_close.argtypes = [c.c_void_p]
        lib.rootw_abort.argtypes = [c.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


def codecs() -> Dict[str, str]:
    """How the library provides each codec: {"zlib": "linked",
    "zstd": "dlopen" or "absent", "lz4": ..., "lzma": ...}."""
    buf = ctypes.create_string_buffer(256)
    if _load().rootio_codecs(buf, 256) < 0:
        raise RuntimeError("rootio_codecs: buffer too small")
    return dict(kv.split("=") for kv in buf.value.decode().split())


class RootFile:
    """Read-only view of a ROOT file's baskets + larcv event decode."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.rootio_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open ROOT file: {path}")
        self.path = path

    def close(self):
        if self._h:
            self._lib.rootio_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def error(self) -> str:
        return self._lib.rootio_error(self._h).decode()

    def branches(self) -> Dict[Tuple[str, str], Dict[str, int]]:
        """{(tree, branch): {"entries": n, "baskets": m}}"""
        out = {}
        n = self._lib.rootio_n_branches(self._h)
        tb = ctypes.create_string_buffer(4096)
        bb = ctypes.create_string_buffer(4096)
        ne = ctypes.c_long()
        nb = ctypes.c_long()
        for i in range(n):
            if self._lib.rootio_branch_info(
                self._h, i, tb, 4096, bb, 4096, ctypes.byref(ne),
                ctypes.byref(nb),
            ) == 0:
                out[(tb.value.decode(), bb.value.decode())] = {
                    "entries": ne.value, "baskets": nb.value,
                }
        return out

    def keys(self) -> List[dict]:
        out = []
        n = self._lib.rootio_n_keys(self._h)
        cls = ctypes.create_string_buffer(256)
        nm = ctypes.create_string_buffer(4096)
        ti = ctypes.create_string_buffer(4096)
        nb = ctypes.c_long()
        ol = ctypes.c_long()
        sk = ctypes.c_long()
        for i in range(n):
            if self._lib.rootio_key_info(
                self._h, i, cls, 256, nm, 4096, ti, 4096,
                ctypes.byref(nb), ctypes.byref(ol), ctypes.byref(sk),
            ) == 0:
                out.append({
                    "class": cls.value.decode(), "name": nm.value.decode(),
                    "title": ti.value.decode(), "nbytes": nb.value,
                    "objlen": ol.value, "seek": sk.value,
                })
        return out

    def read_raw(self, tree: str, branch: str, entry: int) -> bytes:
        """Raw streamed bytes of one entry (for format debugging)."""
        n = self._lib.rootio_entry_size(
            self._h, tree.encode(), branch.encode(), entry
        )
        if n < 0:
            raise IOError(self.error)
        buf = (ctypes.c_uint8 * max(n, 1))()
        got = self._lib.rootio_read_raw(
            self._h, tree.encode(), branch.encode(), entry, buf, n
        )
        if got < 0:
            raise IOError(self.error)
        return bytes(bytearray(buf[:got]))

    def read_event(self, tree: str, branch: str, entry: int
                   ) -> Tuple[Tuple[int, int, int], List[Image2D]]:
        """Decode one larcv EventImage2D entry → (rse, [Image2D])."""
        t, b = tree.encode(), branch.encode()
        nimg = ctypes.c_long()
        rse = (ctypes.c_long * 3)()
        if self._lib.rootio_event_info(
            self._h, t, b, entry, ctypes.byref(nimg), rse
        ) != 0:
            raise IOError(f"{tree}/{branch}[{entry}]: {self.error}")
        run, subrun, event = int(rse[0]), int(rse[1]), int(rse[2])
        images = []
        meta7 = (ctypes.c_double * 7)()
        for i in range(nimg.value):
            if self._lib.rootio_image_meta(self._h, t, b, entry, i, meta7) != 0:
                raise IOError(self.error)
            ox, oy, width, height, rows, cols, plane = [
                meta7[j] for j in range(7)
            ]
            rows, cols, plane = int(rows), int(cols), int(plane)
            px = np.empty(rows * cols, np.float32)
            got = self._lib.rootio_image_pixels(
                self._h, t, b, entry, i,
                px.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), px.size,
            )
            if got != px.size:
                raise IOError(self.error)
            # larcv origin is the image's top-left (min_x, max_y)
            meta = ImageMeta(
                min_x=ox, min_y=oy - height, max_x=ox + width, max_y=oy,
                rows=rows, cols=cols, plane=plane,
            )
            images.append(Image2D(px.reshape(rows, cols), meta,
                                  run, subrun, event))
        return (run, subrun, event), images


class RootWriter:
    """Write larcv-compatible EventImage2D trees — the write-back path
    (reference: IOManager(kWRITE) + per-class score images appended to
    `uburn_plane%d` producers with the original meta + run/subrun/event,
    /root/reference/deploy/run_ubresnet_precropped.py:93-95,159-173).

    Same append/set_id/save_entry surface as data.uevt.EventFileWriter,
    so deploy runners target either format. Backed by the native writer
    in cpp/rootio.cpp; files round-trip through the native reader."""

    def __init__(self, path: str, compress: bool = True,
                 entries_per_basket: int = 4):
        self._lib = _load()
        self._h = self._lib.rootw_open(
            path.encode(), 1 if compress else 0, entries_per_basket
        )
        if not self._h:
            raise IOError(f"cannot create ROOT file: {path}")
        self.path = path
        self._pending: Dict[str, List[Image2D]] = {}
        self._rse = (0, 0, 0)
        # positional consumers (larcv IOManager, RootFile.read_event)
        # pair entry i across ALL producer trees — every tree must have
        # exactly one entry per save_entry() call. Track producers ever
        # seen plus each past entry's rse so a producer that goes
        # missing in an entry (or appears mid-file) stays in sync via
        # empty / backfilled entries.
        self._producers: set = set()
        self._past_rse: List[Tuple[int, int, int]] = []

    @property
    def error(self) -> str:
        return self._lib.rootw_error(self._h).decode()

    def append(self, producer: str, img: Image2D):
        self._pending.setdefault(producer, []).append(img)

    def set_id(self, run: int, subrun: int, event: int):
        self._rse = (int(run), int(subrun), int(event))

    def _write_producer(self, producer: str, imgs: List[Image2D],
                        rse_tuple: Tuple[int, int, int]):
        c = ctypes
        rse = (c.c_long * 3)(*rse_tuple)
        n = len(imgs)
        rows = (c.c_long * max(n, 1))(*[i.meta.rows for i in imgs])
        cols = (c.c_long * max(n, 1))(*[i.meta.cols for i in imgs])
        planes = (c.c_long * max(n, 1))(*[i.meta.plane for i in imgs])
        meta4 = (c.c_double * max(4 * n, 1))()
        for j, im in enumerate(imgs):
            m = im.meta
            # larcv origin = top-left (min_x, max_y)
            meta4[4 * j : 4 * j + 4] = [
                m.min_x, m.max_y, m.max_x - m.min_x, m.max_y - m.min_y,
            ]
        px = np.concatenate(
            [np.asarray(i.pixels, np.float32).reshape(-1) for i in imgs]
        ) if n else np.empty(1, np.float32)
        px = np.ascontiguousarray(px, np.float32)
        rc = self._lib.rootw_write_entry(
            self._h, producer.encode(), rse, n, rows, cols, planes,
            meta4, px.ctypes.data_as(c.POINTER(c.c_float)),
        )
        if rc != 0:
            raise IOError(self.error)

    def save_entry(self):
        for producer in sorted(set(self._pending) | self._producers):
            if producer not in self._producers:
                # producer first seen mid-file: backfill one empty
                # entry per already-saved entry (with that entry's
                # rse) so tree index == global entry index
                for past in self._past_rse:
                    self._write_producer(producer, [], past)
                self._producers.add(producer)
            self._write_producer(
                producer, self._pending.get(producer, []), self._rse
            )
        self._past_rse.append(self._rse)
        self._pending.clear()
        self._rse = (0, 0, 0)

    def close(self):
        if self._h:
            if self._pending:
                self.save_entry()
            if self._lib.rootw_close(self._h) != 0:
                err = self.error
                self._lib.rootw_abort(self._h)
                self._h = None
                raise IOError(err)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None and self._h:
            self._lib.rootw_abort(self._h)
            self._h = None
            return
        self.close()

    def __del__(self):
        try:
            if self._h:
                self._lib.rootw_abort(self._h)
                self._h = None
        except Exception:
            pass


def uevt_to_root(uevt_path: str, out_path: str,
                 producers: Optional[List[str]] = None,
                 verbose: bool = False) -> int:
    """Convert a UEVT event file to a larcv-compatible .root file (the
    converse of root_to_uevt): results flow back to reference-ecosystem
    consumers. Returns entries written."""
    from ubresnet_tpu_torch.data.uevt import EventFileReader

    n = 0
    r = EventFileReader(uevt_path)
    with RootWriter(out_path) as w:
        for e in range(r.n_entries):
            for producer, images in r.read_entry(e, producers).items():
                for img in images:
                    w.append(producer, img)
            w.set_id(*r.rse(e))
            w.save_entry()
            n += 1
            if verbose and n % 100 == 0:
                print(f"{n} entries", flush=True)
    return n


def image2d_trees(rf: RootFile) -> Dict[str, Tuple[str, str, int]]:
    """Map larcv producer → (tree, branch, n_entries) for image2d
    trees, by the larcv naming convention image2d_{producer}_tree.

    Split trees store leaf branches (`<branch>._image_v` etc.); those
    map back to the parent branch name, which the native reader
    reassembles."""
    out = {}
    for (tree, branch), info in sorted(rf.branches().items()):
        if not (tree.startswith("image2d_") and tree.endswith("_tree")):
            continue
        producer = tree[len("image2d_"):-len("_tree")]
        if "." in branch:  # split leaf → parent branch
            parent, leaf = branch.rsplit(".", 1)
            if leaf != "_image_v":
                continue  # id/producer leaves don't define the entry count
            out.setdefault(producer, (tree, parent, info["entries"]))
        else:
            out[producer] = (tree, branch, info["entries"])
    return out


def root_to_uevt(root_path: str, out_path: str,
                 producers: Optional[List[str]] = None,
                 verbose: bool = False) -> int:
    """Convert a larcv .root file to UEVT directly (no ROOT needed).

    Entries are aligned across producers by index (larcv IOManager
    fills all trees per event). Returns entries written."""
    from ubresnet_tpu_torch.data.uevt import EventFileWriter

    with RootFile(root_path) as rf:
        trees = image2d_trees(rf)
        if producers:
            missing = [p for p in producers if p not in trees]
            if missing:
                raise IOError(
                    f"producers {missing} not in {root_path}; found "
                    f"{sorted(trees)} (error: {rf.error or 'none'})"
                )
            trees = {p: trees[p] for p in producers}
        if not trees:
            raise IOError(
                f"no image2d trees found in {root_path} "
                f"(reader error: {rf.error or 'none'}); "
                "run --inspect to see the file's keys"
            )
        n_entries = min(t[2] for t in trees.values())
        n = 0
        with EventFileWriter(out_path) as w:
            for e in range(n_entries):
                rse = None
                for producer, (tree, branch, _) in trees.items():
                    ev_rse, images = rf.read_event(tree, branch, e)
                    rse = rse or ev_rse
                    for img in images:
                        w.append(producer, img)
                if rse:
                    w.set_id(*rse)
                w.save_entry()
                n += 1
                if verbose and n % 100 == 0:
                    print(f"{n} entries", flush=True)
        return n


def inspect_file(path: str) -> str:
    """Human-readable summary of a ROOT file's keys and branches."""
    lines = [f"ROOT file: {path}"]
    with RootFile(path) as rf:
        keys = rf.keys()
        lines.append(f"keys: {len(keys)}")
        for k in keys[:200]:
            lines.append(
                f"  @{k['seek']:<10} {k['class']:<16} {k['name']!r} "
                f"title={k['title']!r} nbytes={k['nbytes']} objlen={k['objlen']}"
            )
        if len(keys) > 200:
            lines.append(f"  ... {len(keys) - 200} more")
        br = rf.branches()
        lines.append(f"branches with baskets: {len(br)}")
        for (tree, branch), info in sorted(br.items()):
            lines.append(
                f"  {tree}/{branch}: {info['entries']} entries in "
                f"{info['baskets']} baskets"
            )
            try:
                rse, imgs = rf.read_event(tree, branch, 0)
                m = imgs[0].meta if imgs else None
                lines.append(
                    f"    entry 0 decodes: rse={rse} images={len(imgs)}"
                    + (f" first={m.rows}x{m.cols} plane={m.plane}" if m else "")
                )
            except IOError as err:
                lines.append(f"    entry 0 larcv decode: {err}")
        if rf.error:
            lines.append(f"reader note: {rf.error}")
    return "\n".join(lines)


class RootEventReader:
    """EventFileReader-compatible view over a larcv .root file, so the
    deploy/serve paths accept .root inputs directly (the reference
    deploy reads larcv ROOT natively, run_ubresnet_precropped.py:83-84).

    Interface subset shared with uevt.EventFileReader: __len__,
    n_entries, rse(entry), producers(entry), read_entry(entry,
    producers=None) → {producer: [Image2D]}.
    """

    def __init__(self, path: str):
        self.path = path
        self._rf = RootFile(path)
        self._trees = image2d_trees(self._rf)
        if not self._trees:
            self._rf.close()
            raise IOError(
                f"no image2d trees found in {path} "
                f"(reader error: {self._rf.error or 'none'})"
            )
        self.n_entries = min(t[2] for t in self._trees.values())

    def __len__(self):
        return self.n_entries

    def producers(self, entry: int = 0):
        return sorted(self._trees)

    def rse(self, entry: int):
        tree, branch, _ = next(iter(self._trees.values()))
        rse, _ = self._rf.read_event(tree, branch, entry)
        return rse

    def read_entry(self, entry: int, producers=None):
        out = {}
        for prod, (tree, branch, _) in self._trees.items():
            if producers is not None and prod not in producers:
                continue
            _, images = self._rf.read_event(tree, branch, entry)
            if images:
                out[prod] = images
        return out

    def close(self):
        self._rf.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def open_event_file(path: str):
    """Open .uevt or .root transparently (format sniffed by magic, not
    extension) with the shared event-reader interface."""
    from ubresnet_tpu_torch.data.uevt import MAGIC, EventFileReader

    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"root":
        return RootEventReader(path)
    if head == MAGIC:
        return EventFileReader(path)
    # fall through on extension for clearer errors from the real reader
    if path.endswith(".root"):
        return RootEventReader(path)
    return EventFileReader(path)
