"""Crop-and-stitch geometry and the device-side split and stitch of the
wholeview path (counterpart of ubresnet_tpu/ops/tiling.py).

The reference splits whole detector views (3456x1008) into overlapping
512x832 crops with larcv::UBSplitDetector and reassembles per-crop
network output with larcv::UBLArFlowStitcher
(deploy/run_ubresnet_wholeview.py:33-55,136,272). The tile grid is
static Python data; ``extract_tiles`` and ``stitch_tiles`` are tensor
code on the runner's device, so whole-plane tensors stay there between
split, inference and stitch.

Overlap policy, as in the JAX package: the mean of all covering crops.
``stitch_tiles`` adds the tiles in grid order into a float32
accumulator, so the same tiles give the same bits as the JAX version.

The geometry functions are verbatim copies of the JAX package's (the
port imports nothing of it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

Grid = Tuple[Tuple[int, int], ...]


def _axis_positions(size: int, tile: int, min_overlap: int) -> List[int]:
    """Evenly-spaced tile starts covering [0, size) with >= min_overlap
    between neighbors and first/last flush with the edges."""
    if tile >= size:
        return [0]
    if min_overlap >= tile:
        # stride would be <= 0: the grid would come out empty (nothing
        # scored) — always a misconfiguration, e.g. a narrow tile_cols
        # with the default 176-column overlap
        raise ValueError(
            f"min_overlap ({min_overlap}) must be < tile ({tile})"
        )
    span = size - tile
    stride = tile - min_overlap
    n = int(np.ceil(span / stride)) + 1
    return [round(i * span / (n - 1)) for i in range(n)]


def tile_grid(
    rows: int,
    cols: int,
    tile_rows: int = 512,
    tile_cols: int = 832,
    min_overlap_rows: int = 16,
    min_overlap_cols: int = 176,
) -> Grid:
    """Static (row0, col0) tile-origin grid covering a (rows, cols)
    image. Defaults reproduce the reference geometry on a 1008x3456
    plane: 2x5 = 10 crops of 512x832 (BBoxPixelHeight/Width + Z
    overlap, run_ubresnet_wholeview.py:38-44)."""
    if tile_rows > rows or tile_cols > cols:
        raise ValueError(
            f"tile ({tile_rows},{tile_cols}) larger than image ({rows},{cols})"
        )
    rpos = _axis_positions(rows, tile_rows, min_overlap_rows)
    cpos = _axis_positions(cols, tile_cols, min_overlap_cols)
    return tuple((r, c) for r in rpos for c in cpos)


def extract_tiles(image: torch.Tensor, grid: Grid, tile_rows: int,
                  tile_cols: int) -> torch.Tensor:
    """(h, w, c) image → (n_tiles, tile_rows, tile_cols, c) crops, a
    stack of slices on the image's device."""
    return torch.stack([image[r:r + tile_rows, c:c + tile_cols]
                        for r, c in grid])


def coverage_count(grid: Grid, tile_rows: int, tile_cols: int,
                   out_hw: Tuple[int, int], device=None) -> torch.Tensor:
    """(h, w, 1) float32 count of the tiles covering each pixel — the
    divisor of ``stitch_tiles``; it depends only on (out_hw, grid)."""
    cnt = torch.zeros(tuple(out_hw) + (1,), dtype=torch.float32,
                      device=device)
    for r, c in grid:
        cnt[r:r + tile_rows, c:c + tile_cols] += 1.0
    return cnt


def stitch_tiles(tiles: torch.Tensor, grid: Grid, out_hw: Tuple[int, int],
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, th, tw, c) per-crop output → (h, w, c) overlap-averaged: the
    tiles added in grid order into a zero accumulator of the tiles'
    dtype, divided by max(count, 1) — the UBLArFlowStitcher role on the
    device. ``count``: ``coverage_count`` of the same grid, if cached."""
    n, th, tw, ch = tiles.shape
    acc = torch.zeros(tuple(out_hw) + (ch,), dtype=tiles.dtype,
                      device=tiles.device)
    for i, (r, c) in enumerate(grid):
        acc[r:r + th, c:c + tw] += tiles[i]
    if count is None:
        count = coverage_count(grid, th, tw, out_hw, tiles.device)
    return acc / torch.clamp(count.to(tiles.dtype), min=1.0)


def random_grid(
    rows: int,
    cols: int,
    tile_rows: int = 512,
    tile_cols: int = 832,
    n_tiles: int = 10,
    rng: Optional[np.random.RandomState] = None,
    max_tiles: int = 1000,
) -> Grid:
    """Random tile origins (UBSplitDetector RandomizeCrops /
    MaxRandomAttempts, run_ubresnet_wholeview.py:44-46)."""
    rng = rng or np.random.RandomState()
    n = min(n_tiles, max_tiles)
    rs = rng.randint(0, rows - tile_rows + 1, size=n)
    cs = rng.randint(0, cols - tile_cols + 1, size=n)
    return tuple((int(r), int(c)) for r, c in zip(rs, cs))


def filter_occupied(
    image: np.ndarray,
    grid: Sequence[Tuple[int, int]],
    tile_rows: int,
    tile_cols: int,
    min_frac_pixels: float = 0.0,
    threshold: float = 10.0,
) -> Grid:
    """Drop tiles whose above-threshold occupancy is below
    min_frac_pixels (UBSplitDetector MinFracPixelsInCrop,
    run_ubresnet_wholeview.py:47). Host-side: it changes the tile
    count."""
    if min_frac_pixels <= 0:
        return tuple(grid)
    out = []
    npx = tile_rows * tile_cols
    for r, c in grid:
        occ = (image[r : r + tile_rows, c : c + tile_cols] > threshold).sum()
        if occ / npx >= min_frac_pixels:
            out.append((r, c))
    return tuple(out)


def coverage(grid: Sequence[Tuple[int, int]], tile_rows: int, tile_cols: int,
             rows: int, cols: int) -> np.ndarray:
    """Host-side coverage counts (for tests / grid sanity checks)."""
    cov = np.zeros((rows, cols), np.int32)
    for r, c in grid:
        cov[r : r + tile_rows, c : c + tile_cols] += 1
    return cov


# ------------------------------------------------ 3-plane consistency
#
# UBSplitDetector (run_ubresnet_wholeview.py:33-55) emits 3D-consistent
# bbox triplets: one 512x832 crop per wire plane (U=0, V=1, Y=2) such
# that all three cover the same detector (y, z) region. The wire-range
# math follows MicroBooNE geometry:
#
#   * wire pitch 0.3 cm on every plane;
#   * Y (collection) wires are vertical: wire = z / pitch;
#   * U/V (induction) wires run at +-60 deg from vertical: their wire
#     coordinate mixes z and y (detector half-height 116.5 cm);
#   * an 832-pixel induction crop covers the full detector height
#     (233 cm * sin60 = 201.8 cm) plus a z slab of 310 px * 0.3 cm *
#     cos60 = 46.5 cm — 828 px in all, which is why the reference pairs
#     BBoxPixelWidth 832 with CoveredZWidth 310.

WIRE_PITCH_CM = 0.3
DET_HALF_HEIGHT_CM = 116.5
_UV_COS = 0.5  # cos(60 deg): z contribution to U/V wire coordinate
_UV_SIN = float(np.sqrt(3.0) / 2.0)  # sin(60 deg): y contribution


def wire_coordinate(
    plane: int,
    y_cm: float,
    z_cm: float,
    half_height_cm: float = DET_HALF_HEIGHT_CM,
) -> float:
    """Fractional wire number of detector point (y, z) on a plane —
    the larcv Geometry::WireCoordinate role for the wholeview split.
    ``half_height_cm`` parameterizes the detector for scaled tests."""
    if plane == 2:  # collection (Y): vertical wires
        return z_cm / WIRE_PITCH_CM
    if plane == 0:  # induction U: wire number grows with z, falls with y
        return (
            z_cm * _UV_COS + (half_height_cm - y_cm) * _UV_SIN
        ) / WIRE_PITCH_CM
    if plane == 1:  # induction V: mirror of U in y
        return (
            z_cm * _UV_COS + (y_cm + half_height_cm) * _UV_SIN
        ) / WIRE_PITCH_CM
    raise ValueError(f"plane must be 0, 1 or 2, got {plane}")


@dataclasses.dataclass(frozen=True)
class TripletCrop:
    """One 3D-consistent crop set: same rows (time) on all planes,
    per-plane column origins, and the detector-z pixel window the
    triplet is guaranteed to share."""

    row0: int
    col0: Tuple[int, int, int]  # (U, V, Y) column origins
    z_window: Tuple[int, int]  # Y-plane columns [z0, z1) covered on all planes

    def origin(self, plane: int) -> Tuple[int, int]:
        return (self.row0, self.col0[plane])


def detsplit_triplets(
    rows: int = 1008,
    cols: int = 3456,
    tile_rows: int = 512,
    tile_cols: int = 832,
    covered_z_width: int = 310,
    min_overlap_rows: int = 16,
    half_height_cm: float = DET_HALF_HEIGHT_CM,
) -> Tuple[TripletCrop, ...]:
    """3-plane consistent tiling of a whole detector view — the
    UBSplitDetector configuration of run_ubresnet_wholeview.py:33-55
    (BBoxPixelHeight/Width 512x832, CoveredZWidth 310).

    The z axis (Y-plane columns) is tiled in consecutive
    ``covered_z_width`` windows covering all ``cols`` columns; each
    window yields, per time band, one crop per plane positioned so the
    window's full (y, z) slab is inside all three crops.
    """
    if tile_cols > cols:
        raise ValueError(f"tile_cols {tile_cols} > image cols {cols}")
    span_needed = (
        2 * half_height_cm * _UV_SIN / WIRE_PITCH_CM
        + covered_z_width * _UV_COS
    )
    if span_needed > tile_cols:
        raise ValueError(
            f"covered_z_width {covered_z_width} needs {span_needed:.0f} "
            f"induction columns > tile_cols {tile_cols}"
        )
    rpos = _axis_positions(rows, tile_rows, min_overlap_rows)
    zpos = _axis_positions(cols, covered_z_width, 0)

    triplets = []
    for z0px in zpos:
        z1px = z0px + covered_z_width
        z0, z1 = z0px * WIRE_PITCH_CM, z1px * WIRE_PITCH_CM
        origins = []
        for plane in (0, 1, 2):
            corners = [
                wire_coordinate(plane, y, z, half_height_cm)
                for y in (-half_height_cm, half_height_cm)
                for z in (z0, z1)
            ]
            center = (min(corners) + max(corners)) / 2.0
            c0 = int(round(center - tile_cols / 2.0))
            origins.append(int(np.clip(c0, 0, cols - tile_cols)))
        for r in rpos:
            triplets.append(
                TripletCrop(int(r), tuple(origins), (z0px, z1px))
            )
    return tuple(triplets)


def triplet_plane_grid(triplets: Sequence[TripletCrop], plane: int) -> Grid:
    """Per-plane (row0, col0) grid view of a triplet set — feeds
    extract_tiles / stitch_tiles."""
    return tuple(t.origin(plane) for t in triplets)


def triplet_consistent(
    t: TripletCrop,
    tile_cols: int = 832,
    half_height_cm: float = DET_HALF_HEIGHT_CM,
) -> bool:
    """True iff every detector point (y, z) in the triplet's z window
    maps inside the crop on all three planes (the 3D-consistency
    invariant UBSplitDetector guarantees)."""
    z0, z1 = (px * WIRE_PITCH_CM for px in t.z_window)
    for plane in (0, 1, 2):
        lo, hi = t.col0[plane], t.col0[plane] + tile_cols
        for y in (-half_height_cm, half_height_cm):
            for z in (z0, z1):
                w = wire_coordinate(plane, y, z, half_height_cm)
                if not (lo - 1e-6 <= w <= hi + 1e-6):
                    return False
    return True
