"""Synthetic LArTPC-like events — the test/smoke fixture.

The reference's de-facto fixture is a small public practice dataset
(practice_train_2k.root, training/ubresnet_example_train.cfg:6). We
generate structurally-similar events instead: sparse ADC images with
straight MIP "tracks" (class 2) and blobby EM "showers" (class 1) on
empty background (class 0), plus the per-pixel weight image the loss
expects (class balancing + vertex up-weighting,
training/pixelwise_nllloss.py:18-23).

Class ids follow the flagship trainer's ordering background/shower/
track (train_ubresnet2018_wlarcv2.py:391-394).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ubresnet_tpu_torch.data.meta import Image2D, ImageMeta
from ubresnet_tpu_torch.data.uevt import EventFileWriter

BACKGROUND, SHOWER, TRACK = 0, 1, 2


def _draw_track(adc, label, rng, value=40.0):
    h, w = adc.shape
    x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
    theta = rng.uniform(0, np.pi)
    length = rng.uniform(0.3, 1.0) * min(h, w)
    n = int(length * 2)
    t = np.linspace(0, length, max(n, 2))
    xs = (x0 + t * np.cos(theta)).astype(int)
    ys = (y0 + t * np.sin(theta)).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys = xs[ok], ys[ok]
    adc[ys, xs] += value * rng.uniform(0.7, 1.3, size=len(xs))
    label[ys, xs] = TRACK
    return (ys[0], xs[0]) if len(xs) else None


def _draw_shower(adc, label, rng, value=25.0):
    h, w = adc.shape
    cx, cy = rng.uniform(0.2 * w, 0.8 * w), rng.uniform(0.2 * h, 0.8 * h)
    npts = rng.randint(50, 200)
    theta = rng.uniform(0, 2 * np.pi)
    spread = rng.uniform(5, 0.15 * min(h, w))
    r = np.abs(rng.normal(0, spread, npts))
    ang = theta + rng.normal(0, 0.4, npts)
    xs = (cx + r * np.cos(ang)).astype(int)
    ys = (cy + r * np.sin(ang)).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    xs, ys = xs[ok], ys[ok]
    adc[ys, xs] += value * rng.uniform(0.5, 1.5, size=len(xs))
    label[ys, xs] = SHOWER
    return (int(cy), int(cx))


def synth_event(
    rng: np.random.RandomState,
    hw: Tuple[int, int] = (256, 256),
    n_tracks: Tuple[int, int] = (1, 4),
    n_showers: Tuple[int, int] = (0, 3),
    adc_noise: float = 0.5,
    noise_occupancy: float = 0.005,
    vertex_weight: float = 10.0,
) -> Dict[str, np.ndarray]:
    """Returns {'wire': f32 (h,w), 'segment': i32 (h,w), 'weight': f32}.

    Images are sparse like thresholded detector data: only hit pixels
    and a small fraction of noise pixels are nonzero (real wire images
    are zero-suppressed; reference masks at ADC>10,
    tf/compare_caffe_to_tf.py:15-17).
    """
    h, w = hw
    adc = np.zeros((h, w), np.float32)
    label = np.zeros((h, w), np.int32)
    vertices = []
    for _ in range(rng.randint(*n_tracks)):
        v = _draw_track(adc, label, rng)
        if v:
            vertices.append(v)
    for _ in range(rng.randint(n_showers[0], n_showers[1] + 1)):
        vertices.append(_draw_shower(adc, label, rng))
    n_noise = int(noise_occupancy * h * w)
    ys = rng.randint(0, h, n_noise)
    xs = rng.randint(0, w, n_noise)
    adc[ys, xs] += rng.exponential(10 * adc_noise, size=n_noise).astype(np.float32)

    # class-balancing weights: w_c = total / (nclasses * n_c)
    weight = np.zeros((h, w), np.float32)
    total = float(h * w)
    for c in (BACKGROUND, SHOWER, TRACK):
        mask = label == c
        n_c = mask.sum()
        if n_c:
            weight[mask] = total / (3.0 * n_c)
    # vertex up-weighting
    for vy, vx in vertices:
        y0, y1 = max(vy - 2, 0), min(vy + 3, h)
        x0, x1 = max(vx - 2, 0), min(vx + 3, w)
        weight[y0:y1, x0:x1] *= vertex_weight
    return {"wire": adc, "segment": label, "weight": weight}


def make_synthetic_file(
    path: str,
    n_events: int = 32,
    hw: Tuple[int, int] = (256, 256),
    seed: int = 0,
    plane: int = 2,
    wholeview: bool = False,
) -> str:
    """Write a UEVT file of synthetic events (wire/segment/weight
    producers — the ThreadProcessor cfg's producer set,
    training/ubresnet_train.cfg:7-27)."""
    rng = np.random.RandomState(seed)
    if wholeview:
        hw = (1008, 3456)  # full plane view (SURVEY.md §0)
    meta = ImageMeta(0.0, 0.0, float(hw[1]), float(hw[0]), hw[0], hw[1], plane)
    with EventFileWriter(path) as out:
        for i in range(n_events):
            ev = synth_event(rng, hw)
            out.set_id(1, 0, i)
            for prod, arr in ev.items():
                out.append(prod, Image2D(arr, meta, 1, 0, i))
            out.save_entry()
    return path
