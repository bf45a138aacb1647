"""Dependency-free PNG writing + simple colormaps (counterpart of
ubresnet_tpu/utils/png.py; the same bytes for the same values).

The reference's comparator dumps colormapped ADC/score/diff images via
OpenCV (tf/compare_caffe_to_tf.py:101-121). cv2 isn't a framework
dependency here; this minimal encoder (zlib + PNG chunks) covers the
visual-diff use case.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb: np.ndarray):
    """rgb: (h, w, 3) uint8."""
    h, w, _ = rgb.shape
    raw = b"".join(
        b"\x00" + rgb[i].astype(np.uint8).tobytes() for i in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def colormap(values: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """(h, w) float → (h, w, 3) uint8, blue→green→red heat map."""
    v = values.astype(np.float32)
    vmin = float(v.min()) if vmin is None else vmin
    vmax = float(v.max()) if vmax is None else vmax
    t = np.clip((v - vmin) / max(vmax - vmin, 1e-12), 0.0, 1.0)
    r = np.clip(2 * t - 1.0, 0, 1)
    g = 1.0 - np.abs(2 * t - 1.0)
    b = np.clip(1.0 - 2 * t, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def save_heatmap(path: str, values: np.ndarray, vmin=None, vmax=None):
    write_png(path, colormap(values, vmin, vmax))
