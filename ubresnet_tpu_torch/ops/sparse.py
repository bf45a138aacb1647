"""Sparse host→device transfer (counterpart of ubresnet_tpu/ops/sparse.py).

LArTPC wire-plane crops are a few percent occupied, so the host ships
fixed-capacity COO (flat index, value) pairs and the device scatters
them into the dense image. The host-side helpers give the same arrays
as the JAX package's numpy ones; each finds a row's nonzeros in one
bool mask (``_nonzero_rows``). ``densify`` is a scatter-add on the
device. Training batches travel in the same form (``sparsify_batch`` /
``densify_batch``, the trainer's default transfer). The sparse
readback of the deploy runners goes the other way: ``dilate_mask``
and ``mask_indices`` pick the charge pixels and their halo on the
host, and ``sparse_gather_forward`` returns the scores of those pixels
only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def round_capacity(nnz: int, bucket: int = 4096) -> int:
    """Round up to the bucket grid (at least one bucket)."""
    return max(bucket, ((nnz + bucket - 1) // bucket) * bucket)


def _nonzero_rows(flat: np.ndarray) -> list:
    """(b, n) → each row's flat indices of its nonzero entries, in
    ascending order, from one ``flat != 0`` bool mask: -0.0 counts as
    a zero, NaN as nonzero, as ``np.nonzero`` counts them. numpy finds
    nonzeros several times faster in bool data than in float data (or
    in a 2-D array), but its bool scan costs the same for every pixel,
    and crops are about 1% occupied. So each row is scanned as 8-pixel
    words first (the mask padded to whole words), and only the bytes
    of the words that hold a pixel are scanned after. The zero is of
    ``flat``'s dtype: a bool mask against an int 0 goes through int64,
    several times slower."""
    b, n = flat.shape
    mask = np.empty((b, -(-n // 8) * 8), bool)
    np.not_equal(flat, flat.dtype.type(0), out=mask[:, :n])
    mask[:, n:] = False
    rows = []
    for words in mask.view(np.uint64):
        hit = np.flatnonzero(words != np.uint64(0))
        byte = np.flatnonzero(words[hit].view(bool))
        rows.append(hit[byte >> 3] * 8 + (byte & 7))
    return rows


def _capacity(rows: list, bucket: int, capacity: int = None,
              min_capacity: int = 0) -> int:
    """COO width: ``capacity`` if given, else the longest row rounded
    to the bucket grid, and at least ``min_capacity``."""
    return capacity or max(min_capacity, round_capacity(
        max(map(len, rows), default=0), bucket))


def _pack(rows: list, k: int, pad: int = 0, flat: np.ndarray = None,
          dtype=np.float32) -> tuple:
    """Per-row flat indices, none longer than ``k`` → (b, k) int32
    indices padded with ``pad``, and with ``flat`` the (b, k) values
    ``flat[i, idx]`` as ``dtype`` padded with 0 (else None)."""
    idx = np.full((len(rows), k), pad, np.int32)
    val = None if flat is None else np.zeros((len(rows), k), dtype)
    for i, r in enumerate(rows):
        idx[i, :len(r)] = r
        if val is not None:
            val[i, :len(r)] = flat[i, r]
    return idx, val


def sparsify(images: np.ndarray, capacity: int = None, bucket: int = 4096,
             min_capacity: int = 0) -> Dict[str, np.ndarray]:
    """(b, h, w) dense → fixed-capacity COO {indices (b, K) int32,
    values (b, K) f32, shape (h, w)}. Pad slots carry index 0 / value 0
    (a scatter-add of zero is a no-op). A row beyond ``capacity``
    keeps its largest-|value| pixels. Without ``capacity``, K is the
    largest row rounded to the bucket, and at least ``min_capacity``
    (a runner's width, which only grows)."""
    b, h, w = images.shape
    flat = images.reshape(b, h * w)
    rows = _nonzero_rows(flat)
    k = _capacity(rows, bucket, capacity, min_capacity)
    for i, idx in enumerate(rows):
        if len(idx) > k:
            rows[i] = idx[np.argsort(np.abs(flat[i, idx]))[-k:]]
    indices, values = _pack(rows, k, flat=flat)
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
    rows = _nonzero_rows(flat)
    return _pack(rows, _capacity(rows, bucket), flat=flat, dtype=dtype)


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


def densify_batch(sp: dict, hw: Tuple[int, int],
                  out: Optional[dict] = None) -> dict:
    """Sparse transfer form (tensors on the device) → dense {image
    (b,h,w,1), label (b,h,w) int32, weight (b,h,w) f32}. Labels are a
    scatter-max into zeros, weights a scatter-add of the residual plus
    the base: index-0/value-0 pad slots change nothing (labels ≥ 0).
    ``out``: dense buffers of those shapes to zero and scatter into in
    place (a captured train step's fixed inputs), returned."""
    h, w = hw
    b = sp["img_idx"].shape[0]
    if out is None:
        out = {"image": sp["img_val"].new_empty((b, h, w, 1)),
               "label": sp["lab_val"].new_empty((b, h, w),
                                                dtype=torch.int32),
               "weight": sp["wgt_val"].new_empty((b, h, w),
                                                 dtype=torch.float32)}
    image = out["image"].view(b, h * w).zero_()
    image.scatter_add_(1, sp["img_idx"].long(), sp["img_val"])
    lab = out["label"].view(b, h * w).zero_()
    lab.scatter_reduce_(1, sp["lab_idx"].long(), sp["lab_val"].to(lab.dtype),
                        reduce="amax")
    wgt = out["weight"].view(b, h * w).zero_()
    wgt.scatter_add_(1, sp["wgt_idx"].long(), sp["wgt_val"].float())
    out["weight"].add_(sp["wgt_base"].float().view(b, 1, 1))
    return out


def mask_indices(mask: np.ndarray, capacity: int = None,
                 bucket: int = 4096, min_capacity: int = 0) -> np.ndarray:
    """(b, h, w) bool → (b, K) int32 flat pixel indices padded with the
    sentinel -1 (never 0, which is pixel (0, 0)). Rows beyond an
    external ``capacity`` truncate; without it K is at least
    ``min_capacity``, as in ``sparsify``."""
    rows = _nonzero_rows(mask.reshape(mask.shape[0], -1))
    k = _capacity(rows, bucket, capacity, min_capacity)
    return _pack([r[:k] for r in rows], k, pad=-1)[0]


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
