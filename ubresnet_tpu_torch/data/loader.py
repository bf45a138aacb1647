"""Threaded batch loading and device prefetch for training (counterpart
of ubresnet_tpu/data/loader.py).

N reader threads randomly access .uevt event files and assemble
batches into a bounded queue while the card computes (the reference's
larcv ThreadProcessor / ThreadDatumFiller, whose loader left the GPUs
idle, grid_scripts/README.md). ``DevicePrefetcher`` keeps batches in
flight on the card: a background thread converts each host batch to
the sparse transfer form when asked (ops/sparse.py:sparsify_batch) and
starts its copy from pinned memory.

Public API as the JAX package's: ``loader.start()``, ``loader[0]``,
``loader.getbatch(bs)``, ``loader.stop()``. larcv ``.root`` inputs are
converted once to a cached ``.uevt`` (``training_paths``), which both
this loader and the C++ filler (data/native.py) read.
"""
from __future__ import annotations

import hashlib
import os
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ubresnet_tpu_torch.data.augment import remap_labels
from ubresnet_tpu_torch.data.uevt import EventFileReader
from ubresnet_tpu_torch.ops.sparse import sparsify_batch
from ubresnet_tpu_torch.utils.native_build import build_dir


def root_cache_dir() -> str:
    """Where converted ``.root`` training files are cached:
    ``build/root_cache/`` under the checkout, the port's own."""
    return str(build_dir().parent / "root_cache")


def _root_training_cache(path: str) -> str:
    """One-time .root → .uevt conversion for training, cached by
    (abspath, mtime, size); concurrent converters race safely through a
    temporary file and an atomic rename."""
    from ubresnet_tpu_torch.data.rootio import root_to_uevt

    st = os.stat(path)
    key = hashlib.sha1(
        f"{os.path.abspath(path)}:{st.st_mtime_ns}:{st.st_size}".encode()
    ).hexdigest()[:16]
    cache_dir = root_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    cached = os.path.join(cache_dir, key + ".uevt")
    if not os.path.exists(cached):
        tmp = cached + f".tmp{os.getpid()}"
        n = root_to_uevt(path, tmp)
        os.replace(tmp, cached)
        print(f"converted {path} -> {cached} ({n} entries, cached for "
              "training reuse)", flush=True)
    return cached


def training_paths(paths):
    """Map larcv .root inputs to their cached-UEVT equivalents (magic
    sniffed); .uevt paths pass through. Both loaders use it, so the C++
    filler serves .root-configured trainings too."""
    out = []
    for p in paths:
        with open(p, "rb") as f:
            head = f.read(4)
        out.append(_root_training_cache(p) if head == b"root" else p)
    return out


def _open_training_file(path: str) -> EventFileReader:
    return EventFileReader(training_paths([path])[0])


class SegmentDataset:
    """UEVT (or larcv .root) entries → {image, label, weight, rse} numpy
    sample dicts. Producer and plane selection mirror the
    ThreadProcessor cfg (training/ubresnet_train.cfg:7-27);
    ``label_offset`` is added to the labels before ``class_map``."""

    def __init__(self, paths: Union[str, Sequence[str]],
                 image_producer: str = "wire",
                 label_producer: str = "segment",
                 weight_producer: Optional[str] = "weight",
                 plane: Optional[int] = None,
                 class_map: Optional[Sequence[int]] = None,
                 label_offset: int = 0,
                 adc_threshold: float = 0.0):
        if isinstance(paths, str):
            paths = [paths]
        self._entries: List = []
        for p in paths:
            r = _open_training_file(p)
            self._entries.extend((r, i) for i in range(len(r)))
        if not self._entries:
            raise ValueError(f"no entries in {paths}")
        self.image_producer = image_producer
        self.label_producer = label_producer
        self.weight_producer = weight_producer
        self.plane = plane
        self.class_map = class_map
        self.label_offset = label_offset
        self.adc_threshold = adc_threshold

    def __len__(self):
        return len(self._entries)

    def _pick(self, images):
        if self.plane is not None:
            for img in images:
                if img.meta.plane == self.plane:
                    return img
            raise KeyError(f"no image for plane {self.plane}")
        return images[0]

    def get(self, idx: int) -> Dict[str, np.ndarray]:
        reader, entry = self._entries[idx]
        ev = reader.read_entry(entry)
        img = self._pick(ev[self.image_producer])
        label = self._pick(ev[self.label_producer]).pixels.astype(np.int32)
        if self.label_offset:
            label = label + self.label_offset
        label = remap_labels(label, self.class_map)
        if self.weight_producer and self.weight_producer in ev:
            weight = self._pick(ev[self.weight_producer]).pixels.astype(
                np.float32)
        else:
            # ones when absent (prep_data, train_ubresnet2018_wlarcv2.py:606-610)
            weight = np.ones_like(label, np.float32)
        pixels = img.pixels.astype(np.float32)
        if self.adc_threshold > 0:
            pixels = np.where(pixels < self.adc_threshold, 0.0, pixels)
        return {"image": pixels[..., None], "label": label, "weight": weight,
                "rse": np.asarray(img.rse, np.int32)}


class BatchLoader:
    """N threads × a bounded queue of ready batches, random access
    (NumThreads / NumBatchStorage / RandomAccess of the reference's
    ThreadProcessor). ``with_rse`` adds each sample's (run, subrun,
    event) as ``rse`` (b, 3) int32."""

    def __init__(self, dataset: SegmentDataset, batch_size: int = 4,
                 n_threads: int = 2, n_buffers: int = 4, shuffle: bool = True,
                 augment: Optional[Callable] = None, seed: int = 0,
                 with_rse: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_threads = n_threads
        self.n_buffers = n_buffers
        self.shuffle = shuffle
        self.augment = augment
        self.seed = seed
        self.with_rse = with_rse
        self._queue: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def start(self, batch_size: Optional[int] = None):
        if batch_size:
            self.batch_size = batch_size
        self._stop.clear()
        self._queue = queue.Queue(maxsize=self.n_buffers)
        for tid in range(self.n_threads):
            t = threading.Thread(target=self._worker, args=(tid,),
                                 daemon=True, name=f"loader{tid}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        if self._queue is not None:
            while True:  # drain so workers blocked on put() can exit
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    def _worker(self, tid: int):
        rng = np.random.RandomState(self.seed + tid)
        n = len(self.dataset)
        while not self._stop.is_set():
            if self.shuffle:
                idxs = rng.randint(0, n, size=self.batch_size)
            else:
                base = rng.randint(0, max(n - self.batch_size, 1))
                idxs = np.arange(base, base + self.batch_size) % n
            batch = self._assemble(idxs)
            if self.augment is not None:
                batch = self.augment(batch, rng)
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def _assemble(self, idxs) -> Dict[str, np.ndarray]:
        samples = [self.dataset.get(int(i)) for i in idxs]
        batch = {k: np.stack([s[k] for s in samples])
                 for k in ("image", "label", "weight")}
        if self.with_rse:
            batch["rse"] = np.stack([s["rse"] for s in samples])
        return batch

    def __getitem__(self, _ignored) -> Dict[str, np.ndarray]:
        if self._queue is None:
            raise RuntimeError("call start() first")
        return self._queue.get(timeout=60.0)

    def getbatch(self, batch_size: Optional[int] = None):
        """Batch of exactly ``batch_size`` rows (the reference's
        ``getbatch(bs)``): smaller requests slice a queued batch, larger
        ones concatenate several."""
        if batch_size is None or batch_size == self.batch_size:
            return self[0]
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        parts, have = [], 0
        while have < batch_size:
            parts.append(self[0])
            have += self.batch_size
        return {k: np.concatenate([p[k] for p in parts])[:batch_size]
                for k in parts[0]}

    def __iter__(self):
        while True:
            yield self[0]


class DevicePrefetcher:
    """Keep ``depth`` batches in flight on ``device``: a background
    thread pulls host batches, drops ``drop_keys`` (the host-side
    ``rse`` by default), converts them to the sparse transfer form when
    ``sparse_bucket`` is set, and starts each copy from pinned memory.
    Each batch keeps its own COO capacity (the JAX prefetcher holds
    capacities sticky so its compiled step sees few shapes; an eager
    step has nothing to recompile)."""

    def __init__(self, source, device: torch.device, depth: int = 2,
                 drop_keys=("rse",), sparse_bucket: int = 0):
        self.source = iter(source)
        self.device = device
        self.depth = depth
        self.drop_keys = drop_keys
        self.sparse_bucket = sparse_bucket
        self.hw = None  # (h, w) of the sparse batches, set on the first

    def _put(self, batch):
        batch = {k: v for k, v in batch.items() if k not in self.drop_keys}
        if self.sparse_bucket:
            batch = sparsify_batch(batch, bucket=self.sparse_bucket)
            self.hw = batch.pop("hw")
        cuda = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if cuda:
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        done = object()

        def feeder():
            try:
                for batch in self.source:
                    if stop.is_set():
                        return
                    q.put(self._put(batch))
            finally:
                q.put(done)

        t = threading.Thread(target=feeder, daemon=True, name="prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                yield item
        finally:
            stop.set()
            try:  # unblock a feeder stuck on put()
                q.get_nowait()
            except queue.Empty:
                pass
