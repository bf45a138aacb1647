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

``compact_readback="sparse"`` ships back only the u8 scores of the
charge pixels and a ``readback_dilate`` halo around them
(ops/sparse.py:sparse_gather_forward); the host pastes them over the
network's zero-input response at that shape (``_bg_field``), which is
the fill of every pixel outside the halo — valid only for trained
networks whose scores decay to it within the halo.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ubresnet_tpu_torch.data.meta import Image2D
from ubresnet_tpu_torch.data.uevt import EventFileWriter
from ubresnet_tpu_torch.deploy.common import (
    check_output,
    open_event_file,
    to_device,
    to_host_async,
    wait_host,
)
from ubresnet_tpu_torch.ops.quant import calibrate
from ubresnet_tpu_torch.ops.sparse import (
    densify,
    dilate_mask,
    mask_indices,
    round_capacity,
    sparse_gather_forward,
    sparsify,
)

SPARSE_BUCKET = 4096  # COO capacity grain (pixels per crop)


class PrecroppedRunner:
    """Score every event of a .uevt file with ``model`` (a port
    UResNet; its device is the runner's device).

    sparse: ship the crops as COO pixels and densify on the device
    (default), or dense; no CLI sets ``sparse=False``, which stays as
    the reference the tests hold the sparse transfer to.
    compact_readback: False (full f32 scores), "f16" (drop the last
    class, ship f16; the host rebuilds it as 1 - sum), "u8" (drop the
    last class, 255-level fixed point) or "sparse" (u8 at the charge
    pixels and a ``readback_dilate`` halo only; needs ``sparse``)."""

    def __init__(self, model, batch_size: int = 8, compact_readback=False,
                 score_dtype=np.float32, sparse: bool = True,
                 readback_dilate: int = 4):
        if compact_readback not in (False, None, "f16", "u8", "sparse"):
            raise ValueError(f"compact_readback={compact_readback!r}: the "
                             "port supports f16, u8 and sparse")
        if compact_readback == "sparse" and not sparse:
            raise ValueError("compact_readback='sparse' requires sparse=True")
        if compact_readback == "sparse":
            # the out-of-halo fill is right only for trained networks
            # whose scores decay to the zero-input response away from
            # charge (random weights deviate by up to ~0.67)
            warnings.warn(
                "compact_readback='sparse' reconstructs pixels outside "
                f"the r={readback_dilate} readback halo from the "
                "network's zero-input response; valid only when the "
                "trained network's scores decay within that halo.",
                stacklevel=2)
        self.model = model
        self.device = next(model.buffers()).device
        self.batch_size = batch_size
        self.sparse = sparse
        self.compact = compact_readback or False
        self.readback_dilate = readback_dilate
        self.score_dtype = np.dtype(score_dtype)
        self._cap = 0
        self._out_cap = 0
        self._bg_fields = {}

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
        """(b, h, w, 1) host batch → (``to_host_async``'s pair, the
        output pixel indices of the sparse readback or None): the
        forward and the device→host copy are enqueued; on the card
        nothing waits here."""
        hw = batch.shape[1:3]
        out_idx = None
        if not self.sparse:
            x = to_device(batch, self.device)
        else:
            sp = sparsify(batch[..., 0], bucket=SPARSE_BUCKET)
            k = sp["indices"].shape[1]
            self._cap = max(self._cap, k)
            idx, val = sp["indices"], sp["values"]
            if k < self._cap:
                pad = ((0, 0), (0, self._cap - k))
                idx, val = np.pad(idx, pad), np.pad(val, pad)
            idx_t, val_t = (to_device(idx, self.device),
                            to_device(val, self.device))
        if self.compact == "sparse":
            halo = dilate_mask(batch[..., 0] != 0.0, self.readback_dilate)
            out_idx = mask_indices(halo, bucket=SPARSE_BUCKET)
            ko = out_idx.shape[1]
            self._out_cap = max(self._out_cap, ko)
            if ko < self._out_cap:
                # pad with the -1 sentinel, never 0: index 0 is pixel
                # (0, 0), and 0-padded slots would overwrite its fill
                out_idx = np.pad(out_idx, ((0, 0), (0, self._out_cap - ko)),
                                 constant_values=-1)
            dev = sparse_gather_forward(self.model, idx_t, val_t,
                                        to_device(out_idx, self.device), hw)
        else:
            if self.sparse:
                x = densify(idx_t, val_t, hw)
            dev = self._post(torch.exp(self.model(x)))
        return to_host_async(dev), out_idx

    def _bg_field(self, hw) -> np.ndarray:
        """The network's response to an all-zero input at this shape,
        (h, w, c) float32 on the host — it depends only on the pixel's
        position (padding at the borders) — computed once per shape:
        the sparse readback's fill outside the halo."""
        hw = tuple(hw)
        if hw not in self._bg_fields:
            z = torch.zeros((1,) + hw + (1,), device=self.device)
            with torch.inference_mode():
                probs = torch.exp(self.model(z))[0]
            self._bg_fields[hw] = probs.float().cpu().numpy()
        return self._bg_fields[hw]

    def _fetch_sparse(self, g: np.ndarray, out_idx: np.ndarray, hw
                      ) -> np.ndarray:
        """Gathered (n, K, c-1) u8 scores and their pixel indices → dense
        (n, h, w, c) float32 probabilities over the zero-input field.
        Slots < 0 are the pad sentinel and are dropped: pasting them
        would overwrite flat pixel 0."""
        g = g.astype(np.float32) * (1.0 / 255.0)
        rest = np.clip(1.0 - g.sum(axis=-1, keepdims=True), 0.0, 1.0)
        vals = np.concatenate([g, rest], axis=-1)
        bg = self._bg_field(hw)
        n = g.shape[0]
        out = np.broadcast_to(bg, (n,) + bg.shape).reshape(
            n, -1, bg.shape[-1]).copy()
        idx = out_idx[:n]
        rows, slots = np.nonzero(idx >= 0)
        out[rows, idx[rows, slots]] = vals[rows, slots]
        return out.reshape((n,) + bg.shape)

    def _fetch(self, pending, n: int, hw) -> np.ndarray:
        """Wait for a dispatched batch and return its first ``n`` rows
        as (n, h, w, c) float32 probabilities, rebuilding the dropped
        class in compact mode."""
        copy, out_idx = pending
        out = wait_host(copy)[:n].numpy()
        if self.compact == "sparse":
            return self._fetch_sparse(out, out_idx, hw)
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
        self._bg_fields.clear()  # the zero-input field moves with the scales
        return len(images)

    def run(self, input_file: str, output_file: str, plane: int = 2,
            producer: str = "wire", n_entries: Optional[int] = None,
            verbose: bool = False) -> OrderedDict:
        timing = OrderedDict(
            [("total", 0.0), ("read", 0.0), ("forward", 0.0), ("write", 0.0)])
        t_total = time.time()
        reader = open_event_file(input_file)
        check_output(output_file)
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
        budget, cached, max_nnz, max_halo = 1 << 29, 0, 1, 1
        for i in range(n):
            im = select(i)
            mask = im.pixels != 0
            max_nnz = max(max_nnz, int(mask.sum()))
            if self.compact == "sparse":
                max_halo = max(max_halo, int(dilate_mask(
                    mask[None], self.readback_dilate).sum()))
            if cached < budget:
                prefetched[i] = im
                cached += im.pixels.nbytes
        self._cap = round_capacity(max_nnz, SPARSE_BUCKET)
        if self.compact == "sparse":
            self._out_cap = round_capacity(max_halo, SPARSE_BUCKET)
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
            scores = self._fetch(pending, len(images),
                                 images[0].pixels.shape)
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
