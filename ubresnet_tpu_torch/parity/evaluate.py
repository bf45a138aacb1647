"""Accuracy evaluation of score files against truth labels
(counterpart of ubresnet_tpu/parity/evaluate.py).

Implements what the reference's analysis stubs declare as intent
(ana/dllee_ssnet_comparison.py:3-7 — standard test-sample evaluation;
caffe/analyze_accuracy.py:3-5 — accuracy vs truth with
ambiguous-label handling): per-class / total / nonzero pixel accuracy,
the full confusion matrix, optional ADC-threshold masking (only score
charge-bearing pixels) and an ignore label for ambiguous truth.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ubresnet_tpu_torch.data.rootio import open_event_file


def evaluate_entry(
    scores: np.ndarray,  # (c, h, w) per-class scores
    truth: np.ndarray,  # (h, w) int labels
    adc: Optional[np.ndarray] = None,
    adc_threshold: float = 10.0,
    ignore_label: Optional[int] = None,
) -> Dict[str, float]:
    nc = scores.shape[0]
    pred = scores.argmax(0)
    mask = np.ones(truth.shape, bool)
    if adc is not None:
        mask &= adc > adc_threshold
    if ignore_label is not None:
        mask &= truth != ignore_label
    confusion = np.zeros((nc, nc), np.int64)
    for t in range(nc):
        sel = mask & (truth == t)
        if sel.any():
            confusion[t] = np.bincount(pred[sel], minlength=nc)
    correct = np.trace(confusion)
    total = confusion.sum()
    out = {"acc_total": correct / total if total else 0.0}
    for c in range(nc):
        n = confusion[c].sum()
        out[f"acc_class{c}"] = confusion[c, c] / n if n else 0.0
    nz = confusion[1:, :]
    out["acc_nonzero"] = (
        np.trace(confusion[1:, 1:]) / nz.sum() if nz.sum() else 0.0
    )
    out["confusion"] = confusion
    out["n_pixels"] = float(total)
    return out


def evaluate_files(
    score_file: str,
    truth_file: str,
    score_producer: str,
    truth_producer: str = "segment",
    adc_producer: Optional[str] = "wire",
    adc_threshold: float = 10.0,
    ignore_label: Optional[int] = None,
    plane: Optional[int] = None,
    n_entries: Optional[int] = None,
) -> Dict[str, float]:
    """Aggregate accuracy of a score file vs a truth file (pixel-summed
    over entries, the ana/ 'standard test sample' evaluation)."""
    from ubresnet_tpu_torch.parity.align import align_entries

    rs = open_event_file(score_file)
    rt = open_event_file(truth_file)
    # pair score and truth entries by (run,subrun,event), not by file
    # position (reference rse discipline,
    # deploy/run_ubresnet_precropped.py:163-168)
    pairs = align_entries(rs, rt, n_entries)
    n = len(pairs)
    confusion = None
    for i_s, i_t in pairs:
        sev = rs.read_entry(i_s, producers=[score_producer])
        tev = rt.read_entry(i_t)
        scores = np.stack([im.pixels for im in sev[score_producer]])
        truths = tev[truth_producer]
        if plane is not None:
            truths = [im for im in truths if im.meta.plane == plane] or truths
        truth = truths[0].pixels.astype(np.int64)
        adc = None
        if adc_producer and adc_producer in tev:
            adcs = tev[adc_producer]
            if plane is not None:
                adcs = [im for im in adcs if im.meta.plane == plane] or adcs
            adc = adcs[0].pixels
        m = evaluate_entry(scores, truth, adc, adc_threshold, ignore_label)
        confusion = m["confusion"] if confusion is None else confusion + m["confusion"]
    nc = confusion.shape[0]
    total = confusion.sum()
    out: Dict[str, float] = {
        "acc_total": float(np.trace(confusion) / total) if total else 0.0,
        "n_entries": float(n),
        "n_pixels": float(total),
    }
    for c in range(nc):
        s = confusion[c].sum()
        out[f"acc_class{c}"] = float(confusion[c, c] / s) if s else 0.0
    nz = confusion[1:, :].sum()
    out["acc_nonzero"] = float(np.trace(confusion[1:, 1:]) / nz) if nz else 0.0
    out["confusion"] = confusion.tolist()
    return out
