"""Precropped inference — batched scoring of event files (counterpart of
ubresnet_tpu/deploy/precropped.py).

Reads one plane's precropped ADC images, scores each batch with the
port's UResNet on its device and writes the per-class score images to
producer ``uburn_plane%d`` with the input's meta and run/subrun/event
ids (the reference's deploy/run_ubresnet_precropped.py:115-194, with
batches that really fill to ``batch_size``).

Structure, as in the JAX runner: a pre-scan fixes one sparse capacity
for the whole run; the host ships COO pixels and the device densifies
them; the tail batch is zero-padded to the batch shape; a one-deep
pipeline dispatches batch k before it drains batch k-1, and a writer
thread owns the output file; ``run`` returns the cumulative timing
dict (total / read / forward / write). ``calibrate_from`` calibrates
an int8 model's activation scales on the input's first images (JAX's
deploy-time PTQ). On the card the drain overlaps
the next batch's compute: each dispatch enqueues its device→host copy
into pinned memory right behind the forward and records an event, so
draining waits for that batch only.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ubresnet_tpu_torch.data.meta import Image2D
from ubresnet_tpu_torch.data.uevt import MAGIC, EventFileReader, EventFileWriter
from ubresnet_tpu_torch.ops.quant import calibrate
from ubresnet_tpu_torch.ops.sparse import densify, round_capacity, sparsify

SPARSE_BUCKET = 4096  # COO capacity grain (pixels per crop)


def open_event_file(path: str) -> EventFileReader:
    """Open a .uevt event file. larcv ``.root`` input is not ported
    yet and raises."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"root" or path.endswith(".root"):
        raise NotImplementedError(
            f"{path}: ROOT event files are not supported by the port yet "
            "(ubresnet_tpu_torch reads and writes .uevt only)")
    if head != MAGIC:
        raise ValueError(f"{path}: not a UEVT file")
    return EventFileReader(path)


class PrecroppedRunner:
    """Score every event of a .uevt file with ``model`` (a port
    UResNet; its device is the runner's device).

    compact_readback: False (full f32 scores), "f16" (drop the last
    class, ship f16; the host rebuilds it as 1 - sum) or "u8" (drop the
    last class, 255-level fixed point)."""

    def __init__(self, model, batch_size: int = 8, compact_readback=False,
                 score_dtype=np.float32):
        if compact_readback not in (False, None, "f16", "u8"):
            raise ValueError(f"compact_readback={compact_readback!r}: the "
                             "port supports f16 and u8")
        self.model = model
        self.device = next(model.buffers()).device
        self.batch_size = batch_size
        self.compact = compact_readback or False
        self.score_dtype = np.dtype(score_dtype)
        self._cap = 0

    def _post(self, probs: torch.Tensor) -> torch.Tensor:
        """Compact device→host form: drop the last class (rows sum to
        1) and ship f16 or u8 fixed point."""
        if self.compact == "u8":
            return torch.round(probs[..., :-1] * 255.0).to(torch.uint8)
        if self.compact == "f16":
            return probs[..., :-1].to(torch.float16)
        return probs

    @torch.inference_mode()
    def _dispatch(self, batch: np.ndarray):
        """(b, h, w, 1) host batch → (host tensor, event or None): the
        forward and the device→host copy are enqueued; on the card
        nothing waits here."""
        cuda = self.device.type == "cuda"
        sp = sparsify(batch[..., 0], bucket=SPARSE_BUCKET)
        k = sp["indices"].shape[1]
        self._cap = max(self._cap, k)
        idx, val = sp["indices"], sp["values"]
        if k < self._cap:
            pad = ((0, 0), (0, self._cap - k))
            idx, val = np.pad(idx, pad), np.pad(val, pad)
        idx_t, val_t = torch.from_numpy(idx), torch.from_numpy(val)
        if cuda:
            idx_t, val_t = idx_t.pin_memory(), val_t.pin_memory()
        x = densify(idx_t.to(self.device, non_blocking=True),
                    val_t.to(self.device, non_blocking=True),
                    batch.shape[1:3])
        dev = self._post(torch.exp(self.model(x)))
        if not cuda:
            return dev, None
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _fetch(self, pending, n: int) -> np.ndarray:
        """Wait for a dispatched batch and return its first ``n`` rows
        as (n, h, w, c) float32 probabilities, rebuilding the dropped
        class in compact mode."""
        host, done = pending
        if done is not None:
            done.synchronize()
        out = host[:n].numpy()
        if self.compact:
            out = out.astype(np.float32)
            if self.compact == "u8":
                out *= 1.0 / 255.0
            rest = np.clip(1.0 - out.sum(axis=-1, keepdims=True), 0.0, 1.0)
            out = np.concatenate([out, rest], axis=-1)
        return out

    def calibrate_from(self, input_file: str, plane: int = 2,
                       producer: str = "wire", n_images: int = 32,
                       percentile: Optional[float] = None) -> int:
        """int8 PTQ calibration (ops/quant.py) from the first
        ``n_images`` of the input itself, in one batch, with the plane
        selection of ``run``; the model (``Policy.int8()``) takes the
        scales. ``percentile`` overrides the policy's statistic. Returns
        the number of images used."""
        reader = open_event_file(input_file)
        images = []
        for i in range(min(n_images, len(reader))):
            imgs = reader.read_entry(i, producers=[producer])[producer]
            images.append(([im for im in imgs if im.meta.plane == plane]
                           or imgs)[0].pixels)
        if not images:
            raise ValueError(f"no '{producer}' images in {input_file}")
        batch = np.stack(images)[..., None].astype(np.float32)
        self.model.set_quant_scales(
            calibrate(self.model, [batch], percentile=percentile))
        return len(images)

    def run(self, input_file: str, output_file: str, plane: int = 2,
            producer: str = "wire", n_entries: Optional[int] = None,
            verbose: bool = False) -> OrderedDict:
        timing = OrderedDict(
            [("total", 0.0), ("read", 0.0), ("forward", 0.0), ("write", 0.0)])
        t_total = time.time()
        reader = open_event_file(input_file)
        if output_file.endswith(".root"):
            raise NotImplementedError(
                f"{output_file}: ROOT output is not supported by the port "
                "yet (write .uevt)")
        writer = EventFileWriter(output_file)
        out_producer = f"uburn_plane{plane}"
        n = len(reader) if n_entries is None else min(n_entries, len(reader))

        def select(i):
            imgs = reader.read_entry(i, producers=[producer])[producer]
            return ([im for im in imgs if im.meta.plane == plane] or imgs)[0]

        # pre-scan the run's largest occupancy so one sparse capacity
        # serves every batch; decoded images are kept (bounded) for the
        # batch loop so each entry is decoded once
        prefetched = {}
        t0 = time.time()
        budget, cached, max_nnz = 1 << 29, 0, 1
        for i in range(n):
            im = select(i)
            max_nnz = max(max_nnz, int(np.count_nonzero(im.pixels)))
            if cached < budget:
                prefetched[i] = im
                cached += im.pixels.nbytes
        self._cap = round_capacity(max_nnz, SPARSE_BUCKET)
        timing["read"] += time.time() - t0

        write_q: "queue.Queue" = queue.Queue(maxsize=2)
        write_err = []

        def write_worker():
            while True:
                item = write_q.get()
                if item is None:
                    return
                images, scores = item
                if write_err:  # keep draining so the producer never blocks
                    continue
                t0 = time.time()
                try:
                    for img, score in zip(images, scores):
                        writer.set_id(*img.rse)
                        for c in range(score.shape[-1]):
                            writer.append(out_producer, Image2D(
                                score[..., c].astype(self.score_dtype),
                                img.meta, *img.rse))
                        writer.save_entry()
                except BaseException as e:  # surfaced after the join
                    write_err.append(e)
                finally:
                    timing["write"] += time.time() - t0

        wthread = threading.Thread(target=write_worker, daemon=True)
        wthread.start()

        def drain(images, pending):
            t0 = time.time()
            scores = self._fetch(pending, len(images))
            timing["forward"] += time.time() - t0
            if write_err:
                raise write_err[0]
            write_q.put((images, scores))

        try:
            last = None
            for start in range(0, n, self.batch_size):
                t0 = time.time()
                images = [prefetched.pop(i, None) or select(i)
                          for i in range(start, min(start + self.batch_size, n))]
                batch = np.stack([im.pixels for im in images]).astype(
                    np.float32)[..., None]
                timing["read"] += time.time() - t0
                t0 = time.time()
                pad = self.batch_size - batch.shape[0]
                if pad:  # keep one batch shape for the whole run
                    batch = np.concatenate(
                        [batch, np.zeros((pad,) + batch.shape[1:],
                                         batch.dtype)])
                pending = self._dispatch(batch)
                timing["forward"] += time.time() - t0
                if last is not None:
                    drain(*last)
                last = (images, pending)
                if verbose:
                    print(f"entries [{start},{start + len(images)}) "
                          "dispatched", flush=True)
            if last is not None:
                drain(*last)
        finally:
            write_q.put(None)
            wthread.join()
        if write_err:
            raise write_err[0]
        writer.close()
        timing["total"] = time.time() - t_total
        if verbose:
            print("------ timing -------")
            for k, v in timing.items():
                print(f"{k} : {v:.3f} s / {v / max(n, 1):.5f} s per event")
        return timing
