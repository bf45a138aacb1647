"""Golden-model parity metrics (counterpart of
ubresnet_tpu/parity/compare.py).

The reference's acceptance test is pixel-level score comparison between
two engines over above-threshold pixels: per-class mean |Δscore| where
ADC > 10 (tf/compare_caffe_to_tf.py:15-17,89-97), plus the argmax label
agreement used as the rebuild's north-star (≥0.999, BASELINE.md).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ubresnet_tpu_torch.data.rootio import open_event_file


def score_diff(
    scores_a: Sequence[np.ndarray],
    scores_b: Sequence[np.ndarray],
    adc: Optional[np.ndarray] = None,
    adc_threshold: float = 10.0,
) -> Dict[str, float]:
    """Per-class mean |Δ| over masked pixels + label agreement.

    scores_a/b: list of (h, w) per-class score images (same order).
    adc: (h, w) charge image for the threshold mask (None = all pixels).
    """
    a = np.stack(scores_a)  # (c, h, w)
    b = np.stack(scores_b)
    mask = np.ones(a.shape[1:], bool) if adc is None else adc > adc_threshold
    n = max(int(mask.sum()), 1)
    out = {}
    for c in range(a.shape[0]):
        out[f"meanabsdiff_class{c}"] = float(
            np.abs(a[c] - b[c])[mask].sum() / n
        )
    agree = (a.argmax(0) == b.argmax(0))[mask]
    out["label_agreement"] = float(agree.mean()) if agree.size else 1.0
    out["n_pixels"] = float(n)
    return out


def compare_score_files(
    file_a: str,
    file_b: str,
    producer_a: str,
    producer_b: str,
    adc_file: Optional[str] = None,
    adc_producer: str = "wire",
    adc_threshold: float = 10.0,
    n_entries: Optional[int] = None,
    dump_dir: Optional[str] = None,
) -> Dict[str, float]:
    """Entry-by-entry comparison of two score files; returns metric
    means over entries (the compare_caffe_to_tf.py loop). When
    dump_dir is set, writes colormapped ADC/score/|diff| PNGs per
    entry (the reference's cv2 dumps, tf/compare_caffe_to_tf.py:
    101-121)."""
    from ubresnet_tpu_torch.parity.align import align_entries

    ra, rb = open_event_file(file_a), open_event_file(file_b)
    radc = open_event_file(adc_file) if adc_file else None
    # pair by (run,subrun,event), not by file position (reference rse
    # discipline, deploy/run_ubresnet_precropped.py:163-168); the ADC
    # file is aligned to file A the same way
    pairs = align_entries(ra, rb, n_entries)
    adc_pairs = dict(align_entries(ra, radc)) if radc is not None else {}
    n = len(pairs)
    acc: Dict[str, List[float]] = {}
    for i, ib in pairs:
        sa = [im.pixels for im in ra.read_entry(i)[producer_a]]
        sb = [im.pixels for im in rb.read_entry(ib)[producer_b]]
        adc = None
        if radc is not None:
            if i not in adc_pairs:
                raise ValueError(
                    f"ADC file {adc_file} has no entry aligned to "
                    f"file-A entry {i} (rse {ra.rse(i)}): the ADC "
                    f"alignment fell back to positional pairing over "
                    f"{len(adc_pairs)} entries — shorter than the "
                    f"compared range"
                )
            imgs = radc.read_entry(adc_pairs[i])[adc_producer]
            adc = imgs[0].pixels
        m = score_diff(sa, sb, adc, adc_threshold)
        for k, v in m.items():
            acc.setdefault(k, []).append(v)
        if dump_dir:
            import os

            from ubresnet_tpu_torch.utils.png import save_heatmap

            os.makedirs(dump_dir, exist_ok=True)
            if adc is not None:
                save_heatmap(os.path.join(dump_dir, f"entry{i}_adc.png"), adc)
            for c, (pa, pb) in enumerate(zip(sa, sb)):
                save_heatmap(
                    os.path.join(dump_dir, f"entry{i}_class{c}_a.png"),
                    pa, 0.0, 1.0,
                )
                save_heatmap(
                    os.path.join(dump_dir, f"entry{i}_class{c}_diff.png"),
                    np.abs(pa - pb), 0.0, 1.0,
                )
    return {k: float(np.mean(v)) for k, v in acc.items()} | {"n_entries": float(n)}
