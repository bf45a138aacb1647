"""Sparse host→device transfer (counterpart of ubresnet_tpu/ops/sparse.py).

LArTPC wire-plane crops are a few percent occupied, so the host ships
fixed-capacity COO (flat index, value) pairs and the device scatters
them into the dense image. The host-side helpers are numpy copies of
the JAX package's; ``densify`` is a scatter-add on the device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def round_capacity(nnz: int, bucket: int = 4096) -> int:
    """Round up to the bucket grid (at least one bucket)."""
    return max(bucket, ((nnz + bucket - 1) // bucket) * bucket)


def sparsify(images: np.ndarray, capacity: int = None,
             bucket: int = 4096) -> Dict[str, np.ndarray]:
    """(b, h, w) dense → fixed-capacity COO {indices (b, K) int32,
    values (b, K) f32, shape (h, w)}. Pad slots carry index 0 / value 0
    (a scatter-add of zero is a no-op). A row beyond ``capacity``
    keeps its largest-|value| pixels."""
    b, h, w = images.shape
    flat = images.reshape(b, h * w)
    nnz = (flat != 0).sum(axis=1)
    k = capacity or round_capacity(int(nnz.max()), bucket)
    indices = np.zeros((b, k), np.int32)
    values = np.zeros((b, k), np.float32)
    for i in range(b):
        idx = np.flatnonzero(flat[i])
        if len(idx) > k:
            top = np.argsort(np.abs(flat[i, idx]))[-k:]
            idx = idx[top]
        indices[i, : len(idx)] = idx
        values[i, : len(idx)] = flat[i, idx]
    return {"indices": indices, "values": values, "shape": (h, w)}


def densify(indices: torch.Tensor, values: torch.Tensor,
            hw: Tuple[int, int]) -> torch.Tensor:
    """(b, K) COO on the device → (b, h, w, 1) dense. Scatter-add into
    zeros, so index-0/value-0 pad slots leave pixel (0, 0) unchanged."""
    b = indices.shape[0]
    h, w = hw
    dense = torch.zeros((b, h * w), dtype=values.dtype,
                        device=values.device)
    dense.scatter_add_(1, indices.long(), values)
    return dense.view(b, h, w, 1)


def mask_indices(mask: np.ndarray, capacity: int = None,
                 bucket: int = 4096) -> np.ndarray:
    """(b, h, w) bool → (b, K) int32 flat pixel indices padded with the
    sentinel -1 (never 0, which is pixel (0, 0)). Rows beyond an
    external ``capacity`` truncate."""
    b = mask.shape[0]
    flat = mask.reshape(b, -1)
    rows, cols = np.nonzero(flat)
    counts = np.bincount(rows, minlength=b)
    k = capacity or round_capacity(
        int(counts.max()) if len(rows) else 0, bucket)
    starts = np.cumsum(counts) - counts
    slots = np.arange(len(rows)) - np.repeat(starts, counts)
    keep = slots < k
    idx = np.full((b, k), -1, np.int32)
    idx[rows[keep], slots[keep]] = cols[keep]
    return idx
