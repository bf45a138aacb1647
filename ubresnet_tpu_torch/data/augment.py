"""Augmentations + label transforms, as pure numpy batch ops (the
port's copy of ubresnet_tpu/data/augment.py).

Reference equivalents:
  * mirror        — SegFiller EnableMirror / BatchFillerImage2D mirror
                    flag (training cfgs; Sem_Seg_ASPP_ResNet1.py uses
                    EnableMirror: true)
  * pad_and_crop  — padandcrop/padandcropandflip: pad 256→264 then take
                    a random 8-px jitter crop, optional random flips
                    (train_ubresnet2018_wlarcv1.py:52-68)
  * remap_labels  — ClassTypeDef 10→3 class remap
                    (train_ubresnet2018_wlarcv1.py:166-167)

These run on the host prefetch threads (cheap memory ops); device-side
jittable variants would cost HBM bandwidth for no win.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

SPATIAL_KEYS = ("image", "label", "weight")


def mirror(batch: Dict[str, np.ndarray], rng: np.random.RandomState,
           prob: float = 0.5) -> Dict[str, np.ndarray]:
    """Random horizontal flip, consistent across image/label/weight."""
    flip = rng.rand(batch["image"].shape[0]) < prob
    out = dict(batch)
    for k in SPATIAL_KEYS:
        if k in out:
            arr = out[k].copy()
            arr[flip] = arr[flip, :, ::-1] if arr.ndim == 3 else arr[flip, :, ::-1, :]
            out[k] = arr
    return out


def pad_and_crop(
    batch: Dict[str, np.ndarray],
    rng: np.random.RandomState,
    pad: int = 8,
    flip: bool = False,
) -> Dict[str, np.ndarray]:
    """Zero-pad by `pad`, random-jitter crop back to the original size,
    optional independent random h/v flips (reference padandcropandflip)."""
    out = dict(batch)
    b = batch["image"].shape[0]
    dx = rng.randint(0, 2 * pad + 1, size=b)
    dy = rng.randint(0, 2 * pad + 1, size=b)
    do_h = rng.rand(b) < 0.5 if flip else np.zeros(b, bool)
    do_v = rng.rand(b) < 0.5 if flip else np.zeros(b, bool)
    for k in SPATIAL_KEYS:
        if k not in out:
            continue
        arr = out[k]
        chan = arr.ndim == 4
        h, w = arr.shape[1], arr.shape[2]
        widths = [(0, 0), (pad, pad), (pad, pad)] + ([(0, 0)] if chan else [])
        padded = np.pad(arr, widths)
        res = np.empty_like(arr)
        for i in range(b):
            crop = padded[i, dy[i] : dy[i] + h, dx[i] : dx[i] + w]
            if do_h[i]:
                crop = crop[:, ::-1]
            if do_v[i]:
                crop = crop[::-1]
            res[i] = crop
        out[k] = res
    return out


def remap_labels(
    labels: np.ndarray, class_map: Optional[Sequence[int]] = None
) -> np.ndarray:
    """Map raw label ids through a lookup table.

    The reference maps 10 larcv particle classes to 3
    (ClassTypeDef: [0,0,0,2,2,2,1,1,1,1], wlarcv1:166-167) and shifts
    labels by -1 after SegFiller (larcv1_interface.py:55-57); pass the
    table that matches your label producer.
    """
    if class_map is None:
        return labels
    lut = np.asarray(class_map, dtype=labels.dtype)
    return lut[labels]


DEFAULT_CLASS_MAP_10TO3 = (0, 0, 0, 2, 2, 2, 1, 1, 1, 1)
