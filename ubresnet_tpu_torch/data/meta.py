"""Image containers with physical-coordinate metadata.

Capability-parity with larcv's Image2D/ImageMeta (exercised at
deploy/run_ubresnet_wholeview.py:219-229: meta.rows()/cols(),
min_x/max_y, row()/col() coordinate mapping; and
deploy/run_ubresnet_precropped.py:164-172: per-image meta carried to
output, run/subrun/event ids).

Conventions (matching larcv): the image is a (rows, cols) array;
columns map to x (wire), rows map to y (tick). min_y is the *bottom*
edge; row 0 is the *top* (max_y), as in larcv's row() math.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageMeta:
    min_x: float
    min_y: float
    max_x: float
    max_y: float
    rows: int
    cols: int
    plane: int = 0

    @property
    def width(self) -> float:
        return self.max_x - self.min_x

    @property
    def height(self) -> float:
        return self.max_y - self.min_y

    @property
    def pixel_width(self) -> float:
        return self.width / self.cols

    @property
    def pixel_height(self) -> float:
        return self.height / self.rows

    def col(self, x: float) -> int:
        if not (self.min_x <= x < self.max_x):
            raise ValueError(f"x={x} outside [{self.min_x},{self.max_x})")
        return int((x - self.min_x) / self.pixel_width)

    def row(self, y: float) -> int:
        if not (self.min_y < y <= self.max_y):
            raise ValueError(f"y={y} outside ({self.min_y},{self.max_y}]")
        return int((self.max_y - y) / self.pixel_height)

    def pos_x(self, col: int) -> float:
        return self.min_x + (col + 0.5) * self.pixel_width

    def pos_y(self, row: int) -> float:
        return self.max_y - (row + 0.5) * self.pixel_height

    def crop(self, row0: int, col0: int, rows: int, cols: int) -> "ImageMeta":
        """Meta of a pixel-space crop [row0:row0+rows, col0:col0+cols]."""
        return ImageMeta(
            min_x=self.min_x + col0 * self.pixel_width,
            min_y=self.max_y - (row0 + rows) * self.pixel_height,
            max_x=self.min_x + (col0 + cols) * self.pixel_width,
            max_y=self.max_y - row0 * self.pixel_height,
            rows=rows,
            cols=cols,
            plane=self.plane,
        )

    def contains(self, other: "ImageMeta") -> bool:
        return (
            self.min_x <= other.min_x
            and self.max_x >= other.max_x
            and self.min_y <= other.min_y
            and self.max_y >= other.max_y
        )


@dataclasses.dataclass
class Image2D:
    """A (rows, cols) pixel array + meta + event ids."""

    pixels: np.ndarray
    meta: ImageMeta
    run: int = 0
    subrun: int = 0
    event: int = 0

    def __post_init__(self):
        if self.pixels.shape != (self.meta.rows, self.meta.cols):
            raise ValueError(
                f"pixels {self.pixels.shape} != meta ({self.meta.rows},{self.meta.cols})"
            )

    @property
    def rse(self) -> Tuple[int, int, int]:
        return (self.run, self.subrun, self.event)

    def crop(self, row0: int, col0: int, rows: int, cols: int) -> "Image2D":
        return Image2D(
            pixels=self.pixels[row0 : row0 + rows, col0 : col0 + cols].copy(),
            meta=self.meta.crop(row0, col0, rows, cols),
            run=self.run,
            subrun=self.subrun,
            event=self.event,
        )
