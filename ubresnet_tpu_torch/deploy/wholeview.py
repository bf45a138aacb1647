"""Whole-view inference — split, score, stitch on the device
(counterpart of ubresnet_tpu/deploy/wholeview.py).

The reference's deploy/run_ubresnet_wholeview.py pipeline, for the
single-input, per-plane, 3-class UResNet or ASPP-ResNet:

  1. read whole-plane ADC images (e.g. 1008x3456) from .uevt or larcv
     .root,
  2. ship each as sparse COO pixels and densify it on the device,
  3. either tile it into overlapping 512x832 crops (UBSplitDetector
     role, ops/tiling.py), score the crops ``crop_batch`` at a time and
     overlap-average them back (UBLArFlowStitcher role) — the stitched
     path — or, with ``spatial``, pad the plane to a multiple of 32 and
     score it in one forward at batch 1 — on one device, or, given
     several ``devices``, row-sharded over them with halo exchange
     (models/uresnet.py:ZoneModel.forward_rows, the counterpart of the
     JAX package's ``spatial_mesh``),
  4. write per-class images to producer ``ubsnet_plane%d`` with the
     input's meta and run/subrun/event ids, to .uevt or larcv .root.

Only the stitched scores leave the device. ``run`` dispatches every
plane of an entry before it drains any, so plane k's device→host copy
(pinned memory, one CUDA event per plane) overlaps plane k+1's
compute, and a writer thread owns the output file, as in the
precropped runner.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ubresnet_tpu_torch.data.meta import Image2D
from ubresnet_tpu_torch.data.rootio import open_event_file
from ubresnet_tpu_torch.deploy.common import (
    open_score_writer,
    to_device,
    to_host_async,
    wait_host,
)
from ubresnet_tpu_torch.ops.quant import calibrate
from ubresnet_tpu_torch.parallel.sharding import (
    SPATIAL_DIVISOR,
    row_gather,
    row_split,
)
from ubresnet_tpu_torch.ops.sparse import densify, sparsify
from ubresnet_tpu_torch.ops.tiling import (
    coverage_count,
    detsplit_triplets,
    extract_tiles,
    filter_occupied,
    random_grid,
    stitch_tiles,
    tile_grid,
    triplet_plane_grid,
)


class WholeViewRunner:
    """Score whole planes with ``model`` (a port eval model, UResNet or
    ASPP-ResNet, as PrecroppedRunner takes it; ``model.device`` is the
    runner's device).

    spatial: score each plane in one forward (padded to
    ``SPATIAL_DIVISOR`` on the high side) instead of crop-and-stitch;
    ``grid`` arguments are then ignored. sparse: ship planes as COO
    pixels (capacity on a ``sparse_bucket`` grid, which only grows) or
    dense. score_dtype: storage dtype of the written score images
    (.uevt outputs; a .root output stores float32). devices: with more
    than one, the spatial path splits each padded plane by rows over
    them (parallel/sharding.py:row_split; a device may repeat), runs
    the row-sharded forward with a replica of the model on each other
    device, and gathers the probabilities on the model's device."""

    def __init__(
        self,
        model,
        tile_rows: int = 512,
        tile_cols: int = 832,
        min_overlap_rows: int = 16,
        min_overlap_cols: int = 176,
        crop_batch: int = 10,
        sparse: bool = True,
        sparse_bucket: int = 8192,
        covered_z_width: int = 310,
        det_half_height_cm: Optional[float] = None,
        spatial: bool = False,
        score_dtype=np.float32,
        devices: Optional[Sequence] = None,
    ):
        self.model = model
        self.device = model.device
        self.tile_rows = tile_rows
        self.tile_cols = tile_cols
        self.min_overlap_rows = min_overlap_rows
        self.min_overlap_cols = min_overlap_cols
        self.crop_batch = crop_batch
        self.sparse = sparse
        self.sparse_bucket = sparse_bucket
        self.covered_z_width = covered_z_width
        self.det_half_height_cm = det_half_height_cm
        self.spatial = spatial
        self.score_dtype = np.dtype(score_dtype)
        self._cap = 0
        self._plans = {}  # (hw, grid) → (grid, coverage count on device)
        self.devices = None
        self.last_halo = None  # the last row-sharded plane's halo counts
        self.replicas = {}  # device → the model there, beside model.device
        if devices is not None and len(devices) > 1:
            if not spatial:
                raise ValueError("devices: the stitched path runs on one "
                                 "device; row sharding is the spatial "
                                 "path's")
            self.devices = [torch.device(d) for d in devices]
            for d in self.devices:
                if d != self.device and d not in self.replicas:
                    self.replicas[d] = model.replica(d)

    def _grid(self, hw: Tuple[int, int]):
        return tile_grid(hw[0], hw[1], self.tile_rows, self.tile_cols,
                         self.min_overlap_rows, self.min_overlap_cols)

    def _plan(self, hw: Tuple[int, int], grid=None):
        """The grid (default: ``tile_grid`` of ``hw``) and its coverage
        count, computed once per (hw, grid)."""
        key = (hw, grid)
        if key not in self._plans:
            g = self._grid(hw) if grid is None else grid
            self._plans[key] = (g, coverage_count(
                g, self.tile_rows, self.tile_cols, hw, self.device))
        return self._plans[key]

    def _stitched(self, image: torch.Tensor, grid) -> torch.Tensor:
        """(h, w, 1) plane on the device → (h, w, c) stitched
        probabilities: extract, zero-pad the tile count to a multiple of
        ``crop_batch``, score chunk by chunk, stitch."""
        hw = tuple(image.shape[:2])
        grid, count = self._plan(hw, grid)
        tiles = extract_tiles(image, grid, self.tile_rows, self.tile_cols)
        n_tiles = len(grid)
        n_pad = (-n_tiles) % self.crop_batch
        if n_pad:  # every chunk has the one batch shape
            tiles = torch.cat([tiles, tiles.new_zeros(
                (n_pad,) + tiles.shape[1:])])
        scores = torch.cat([torch.exp(self.model(chunk))
                            for chunk in tiles.split(self.crop_batch)])
        return stitch_tiles(scores[:n_tiles], grid, hw, count)

    def _whole(self, image: torch.Tensor) -> torch.Tensor:
        """(h, w, 1) plane → (h, w, c) probabilities from one forward of
        the plane zero-padded on the high side to the stride multiple."""
        h, w = image.shape[:2]
        # every decoder upsample an exact 2x (1008 -> 1024 rows), as the
        # JAX package pads
        pad_r = (-h) % SPATIAL_DIVISOR
        pad_c = (-w) % SPATIAL_DIVISOR
        x = F.pad(image, (0, 0, 0, pad_c, 0, pad_r))[None]
        if self.devices is None:
            return torch.exp(self.model(x))[0, :h, :w, :]
        out = self.model.forward_rows(row_split(x, self.devices),
                                      replicas=self.replicas)
        self.last_halo = out.halo
        return torch.exp(row_gather(out, self.device))[0, :h, :w, :]

    @torch.inference_mode()
    def dispatch_image(self, image: np.ndarray,
                       grid: Optional[Tuple[Tuple[int, int], ...]] = None):
        """Enqueue one plane's transfer, scoring and device→host copy;
        returns what ``fetch`` waits for. On the card nothing waits
        here, so the caller can dispatch several planes and fetch them
        in order."""
        hw = tuple(image.shape[:2])
        if self.sparse:
            sp = sparsify(image[None].astype(np.float32),
                          bucket=self.sparse_bucket, min_capacity=self._cap)
            idx, val = sp["indices"], sp["values"]
            self._cap = idx.shape[1]  # the capacity only grows
            x = densify(to_device(idx, self.device),
                        to_device(val, self.device), hw)[0]
        else:
            x = to_device(image.astype(np.float32), self.device)[..., None]
        return to_host_async(self._whole(x) if self.spatial
                             else self._stitched(x, grid))

    @staticmethod
    def fetch(pending) -> np.ndarray:
        """Wait for a dispatched plane: (h, w, c) float32 probabilities."""
        return wait_host(pending).numpy()

    def score_image(self, image: np.ndarray,
                    grid: Optional[Tuple[Tuple[int, int], ...]] = None
                    ) -> np.ndarray:
        """(h, w) ADC → (h, w, classes) probabilities. ``grid``
        overrides the default tile grid of the stitched path (the
        detector-consistent triplet path)."""
        return self.fetch(self.dispatch_image(image, grid))

    def calibrate_from(
        self,
        input_file: str,
        producer: str = "wire",
        planes: Optional[Sequence[int]] = None,
        n_images: int = 4,
        percentile: Optional[float] = None,
        adc_threshold: float = 10.0,
    ) -> int:
        """int8 PTQ calibration (ops/quant.py) from the first
        ``n_images`` whole-plane images of the input: each plane is
        tiled with the stitched path's static grid and only occupied
        tiles (any pixel >= ``adc_threshold``) feed the calibration, in
        batches of ``crop_batch``. The model (``Policy.int8()``) takes
        the scales; ``percentile`` overrides the policy's statistic.
        Returns the number of calibration tiles."""
        reader = open_event_file(input_file)
        tiles = []
        n_planes = 0
        for i in range(len(reader)):
            if n_planes >= n_images:
                break
            ev = reader.read_entry(i, producers=[producer])
            for im in ev.get(producer, []):
                if planes is not None and im.meta.plane not in planes:
                    continue
                if n_planes >= n_images:
                    break
                n_planes += 1
                px = np.asarray(im.pixels, np.float32)
                for r0, c0 in self._grid(px.shape[:2]):
                    t = px[r0 : r0 + self.tile_rows,
                           c0 : c0 + self.tile_cols]
                    if (t >= adc_threshold).any():
                        tiles.append(t)
        if not tiles:
            raise ValueError(
                f"no occupied '{producer}' tiles in {input_file}")
        batches = [np.stack(tiles[j : j + self.crop_batch])[..., None]
                   for j in range(0, len(tiles), self.crop_batch)]
        scales = calibrate(self.model, batches, percentile=percentile)
        for m in (self.model, *self.replicas.values()):
            m.set_quant_scales(scales)
        return len(tiles)

    def make_bboxes(
        self,
        image: np.ndarray,
        randomize: bool = False,
        n_random: int = 10,
        min_frac_pixels: float = 0.0,
        adc_threshold: float = 10.0,
        rng=None,
    ):
        """Tile-origin (row0, col0) sets for an image — the
        UBSplitDetector bbox-producer role (OutputBBox2DProducer,
        RandomizeCrops, MinFracPixelsInCrop,
        run_ubresnet_wholeview.py:35-47). The stitched path always
        scores the full static grid; this is for crop-level
        consumers."""
        if randomize:
            grid = random_grid(
                image.shape[0], image.shape[1], self.tile_rows,
                self.tile_cols, n_tiles=n_random, rng=rng)
        else:
            grid = self._grid(image.shape[:2])
        return filter_occupied(image, grid, self.tile_rows, self.tile_cols,
                               min_frac_pixels, adc_threshold)

    def _detsplit_grids(self, hw: Tuple[int, int]):
        """Per-plane grids from 3D-consistent triplets (UBSplitDetector
        semantics, ops/tiling.py:detsplit_triplets), cached per shape."""
        key = ("detsplit", hw)
        if key not in self._plans:
            kw = {}
            if self.det_half_height_cm is not None:
                kw["half_height_cm"] = self.det_half_height_cm
            trips = detsplit_triplets(
                hw[0], hw[1], self.tile_rows, self.tile_cols,
                covered_z_width=self.covered_z_width,
                min_overlap_rows=self.min_overlap_rows, **kw)
            self._plans[key] = {p: triplet_plane_grid(trips, p)
                                for p in (0, 1, 2)}
        return self._plans[key]

    def run(
        self,
        input_file: str,
        output_file: str,
        producer: str = "wire",
        planes: Optional[Sequence[int]] = None,
        n_entries: Optional[int] = None,
        detsplit: bool = False,
        passthrough: bool = False,
        verbose: bool = False,
    ) -> OrderedDict:
        """Score whole views. ``detsplit`` positions each plane's crops
        by the 3D-consistent triplet math instead of independent
        per-plane grids; ``passthrough`` copies the input event's
        content into the output beside the scores (the reference's
        IOManager kBOTH mode, run_ubresnet_wholeview.py:130-133).
        Returns the cumulative timing dict (total / read / splitscore /
        write)."""
        timing = OrderedDict(
            [("total", 0.0), ("read", 0.0), ("splitscore", 0.0),
             ("write", 0.0)])
        t_total = time.time()
        reader = open_event_file(input_file)
        writer, out_dt = open_score_writer(output_file, self.score_dtype)
        n = len(reader) if n_entries is None else min(n_entries, len(reader))

        write_q: "queue.Queue" = queue.Queue(maxsize=2)
        write_err = []

        def write_worker():
            while True:
                item = write_q.get()
                if item is None:
                    return
                if write_err:  # keep draining so the producer never blocks
                    continue
                ev, images, scores = item
                t0 = time.time()
                try:
                    for prod, imgs in (ev or {}).items():
                        for im in imgs:
                            writer.append(prod, im)
                    for img, score in zip(images, scores):
                        for c in range(score.shape[-1]):
                            writer.append(
                                f"ubsnet_plane{img.meta.plane}",
                                Image2D(score[..., c].astype(out_dt),
                                        img.meta, *img.rse))
                    # one output entry per event, all planes
                    if images:
                        writer.set_id(*images[0].rse)
                    writer.save_entry()
                except BaseException as e:  # surfaced after the join
                    write_err.append(e)
                finally:
                    timing["write"] += time.time() - t0

        wthread = threading.Thread(target=write_worker, daemon=True)
        wthread.start()
        try:
            for i in range(n):
                t0 = time.time()
                ev = reader.read_entry(
                    i, producers=None if passthrough else [producer])
                images = ev[producer]
                if planes is not None:
                    images = [im for im in images if im.meta.plane in planes]
                timing["read"] += time.time() - t0

                # dispatch every plane of the entry, then drain in order
                t0 = time.time()
                in_flight = []
                for img in images:
                    grid = None
                    if detsplit:
                        grid = self._detsplit_grids(
                            img.pixels.shape[:2])[img.meta.plane]
                    in_flight.append(self.dispatch_image(img.pixels, grid))
                scores = [self.fetch(p) for p in in_flight]
                timing["splitscore"] += time.time() - t0
                if write_err:
                    raise write_err[0]
                write_q.put((ev if passthrough else None, images, scores))
                if verbose:
                    print(f"entry {i}: {len(images)} planes scored",
                          flush=True)
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
