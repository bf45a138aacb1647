"""Sparse host→device transfer (counterpart of ubresnet_tpu/ops/sparse.py).

LArTPC wire-plane crops are a few percent occupied, so the host ships
fixed-capacity COO (flat index, value) pairs and the device scatters
them into the dense image. The host-side helpers are numpy copies of
the JAX package's; ``densify`` is a scatter-add on the device.
Training batches travel in the same form (``sparsify_batch`` /
``densify_batch``, the trainer's default transfer). The sparse
readback of the deploy runners goes the other way: ``dilate_mask``
and ``mask_indices`` pick the charge pixels and their halo on the
host, and ``sparse_gather_forward`` returns the scores of those pixels
only.
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


def _coo_rows(flat: np.ndarray, bucket: int, dtype) -> tuple:
    """(b, n) → idx (b, K) int32, val (b, K) of the nonzero entries,
    K = the batch's largest row count rounded to the bucket."""
    b = flat.shape[0]
    rows, cols = np.nonzero(flat)
    counts = np.bincount(rows, minlength=b)
    k = round_capacity(int(counts.max()) if len(rows) else 0, bucket)
    starts = np.cumsum(counts) - counts
    slots = np.arange(len(rows)) - np.repeat(starts, counts)
    idx = np.zeros((b, k), np.int32)
    val = np.zeros((b, k), dtype)
    idx[rows, slots] = cols
    val[rows, slots] = flat[rows, cols]
    return idx, val


def sparsify_batch(batch: dict, bucket: int = 2048) -> dict:
    """Training batch {image (b,h,w,1), label (b,h,w), weight (b,h,w)}
    → the sparse transfer form: image and label as COO over their
    nonzero pixels; weight as a per-image base (the weight of the first
    zero-ADC pixel, or the row median when there is none) plus a COO
    residual. Host numpy, vectorised."""
    img = np.ascontiguousarray(batch["image"][..., 0])
    lab = batch["label"]
    wgt = batch["weight"]
    b, h, w = img.shape
    out = {"hw": (h, w)}
    flat = img.reshape(b, -1)
    out["img_idx"], out["img_val"] = _coo_rows(flat, bucket, np.float32)
    out["lab_idx"], out["lab_val"] = _coo_rows(lab.reshape(b, -1), bucket,
                                               np.int32)
    wflat = wgt.reshape(b, -1).astype(np.float32)
    bg = flat == 0
    has_bg = bg.any(axis=1)
    base = wflat[np.arange(b), bg.argmax(axis=1)]
    if not has_bg.all():
        med = np.median(wflat[~has_bg], axis=1)
        base = np.where(has_bg, base, 0.0)
        base[~has_bg] = med
    resid = wflat - base[:, None]
    resid[np.abs(resid) < 1e-12] = 0.0
    out["wgt_base"] = base.astype(np.float32)
    out["wgt_idx"], out["wgt_val"] = _coo_rows(resid, bucket, np.float32)
    return out


def densify_batch(sp: dict, hw: Tuple[int, int]) -> dict:
    """Sparse transfer form (tensors on the device) → dense {image
    (b,h,w,1), label (b,h,w) int32, weight (b,h,w) f32}. Labels are a
    scatter-max into zeros, weights a scatter-add of the residual plus
    the base: index-0/value-0 pad slots change nothing (labels ≥ 0)."""
    h, w = hw
    image = densify(sp["img_idx"], sp["img_val"], hw)
    b = image.shape[0]
    lab = torch.zeros((b, h * w), dtype=torch.int32,
                      device=sp["lab_val"].device)
    lab.scatter_reduce_(1, sp["lab_idx"].long(), sp["lab_val"].to(lab.dtype),
                        reduce="amax")
    wgt = torch.zeros((b, h * w), dtype=torch.float32,
                      device=sp["wgt_val"].device)
    wgt.scatter_add_(1, sp["wgt_idx"].long(), sp["wgt_val"].float())
    wgt = wgt.view(b, h, w) + sp["wgt_base"].float().view(b, 1, 1)
    return {"image": image, "label": lab.view(b, h, w), "weight": wgt}


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


def dilate_mask(mask: np.ndarray, r: int) -> np.ndarray:
    """(b, h, w) bool → square dilation by ``r`` pixels (separable
    OR-shifts, O(r·hw)): the halo around charge where the network's
    scores depart from its zero-input response. Never aliases its
    input, also at r ≤ 0: callers may mutate the result."""
    if r <= 0:
        return mask.copy()
    rowd = mask.copy()
    for s in range(1, r + 1):
        rowd[:, s:, :] |= mask[:, :-s, :]
        rowd[:, :-s, :] |= mask[:, s:, :]
    out = rowd.copy()
    for s in range(1, r + 1):
        out[:, :, s:] |= rowd[:, :, :-s]
        out[:, :, :-s] |= rowd[:, :, s:]
    return out


def sparse_gather_forward(model, indices: torch.Tensor, values: torch.Tensor,
                          out_idx: torch.Tensor, hw: Tuple[int, int]
                          ) -> torch.Tensor:
    """COO input (b, K) and output pixel indices (b, Ko) on the model's
    device → (b, Ko, C-1) uint8 scores at those pixels: densify, the
    model, exp, a gather at ``out_idx`` (the -1 pad sentinel clamped to
    pixel 0, whose value the host paste drops), the first C-1 classes
    in 255-level fixed point (the host rebuilds the last as 1 - sum)."""
    probs = torch.exp(model(densify(indices, values, hw)))
    b, h, w, c = probs.shape
    idx = out_idx.long().clamp(min=0).unsqueeze(-1).expand(-1, -1, c)
    g = torch.gather(probs.reshape(b, h * w, c), 1, idx)
    return torch.round(g[..., :-1] * 255.0).to(torch.uint8)
