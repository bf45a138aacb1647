"""Synthetic LArTPC crops: the benchmark's frozen copy of the port's
fixture generator (ubresnet_tpu_torch/data/synthetic.py:synth_event).

Sparse ADC images with straight MIP tracks (class 2) and blobby EM
showers (class 1) on empty background (class 0), thresholded like
detector data, plus the per-pixel weight image of the loss (class
balancing and vertex up-weighting, the reference's
training/pixelwise_nllloss.py:18-23). A traffic file's ``generator``
section sets the parameters.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

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


def synth_event(rng: np.random.RandomState, hw: Tuple[int, int],
                n_tracks: Tuple[int, int] = (1, 4),
                n_showers: Tuple[int, int] = (0, 3),
                adc_noise: float = 0.5, noise_occupancy: float = 0.005,
                vertex_weight: float = 10.0) -> Dict[str, np.ndarray]:
    """{'wire': f32 (h, w), 'segment': i32 (h, w), 'weight': f32 (h, w)}:
    [lo, hi) tracks, [lo, hi] showers, ``noise_occupancy`` of the pixels
    noise hits."""
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
    adc[ys, xs] += rng.exponential(10 * adc_noise,
                                   size=n_noise).astype(np.float32)
    # class-balancing weights: w_c = total / (nclasses * n_c)
    weight = np.zeros((h, w), np.float32)
    total = float(h * w)
    for c in (BACKGROUND, SHOWER, TRACK):
        mask = label == c
        n_c = mask.sum()
        if n_c:
            weight[mask] = total / (3.0 * n_c)
    for vy, vx in vertices:
        y0, y1 = max(vy - 2, 0), min(vy + 3, h)
        x0, x1 = max(vx - 2, 0), min(vx + 3, w)
        weight[y0:y1, x0:x1] *= vertex_weight
    return {"wire": adc, "segment": label, "weight": weight}


def crops(rng: np.random.RandomState, n: int, hw: Tuple[int, int],
          generator: dict) -> Dict[str, np.ndarray]:
    """``n`` events stacked: image (n, h, w, 1) f32, label (n, h, w) i32,
    weight (n, h, w) f32. Every seed draws the same numbers of tracks and
    showers, each (tracks, showers) pair of the generator's ranges in
    turn, in an order drawn from the seed: the seed moves the crops, not
    the amount of work."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in generator.items()}
    t_lo, t_hi = kw.pop("n_tracks", (1, 4))
    s_lo, s_hi = kw.pop("n_showers", (0, 3))
    pairs = [(t, s) for t in range(t_lo, t_hi) for s in range(s_lo, s_hi + 1)]
    order = rng.permutation(n)
    evs = []
    for i in order:
        t, s = pairs[i % len(pairs)]
        evs.append(synth_event(rng, tuple(hw), n_tracks=(t, t + 1),
                               n_showers=(s, s), **kw))
    return {"image": np.stack([e["wire"] for e in evs])[..., None],
            "label": np.stack([e["segment"] for e in evs]),
            "weight": np.stack([e["weight"] for e in evs])}
