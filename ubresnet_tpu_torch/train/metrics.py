"""Metrics: per-class pixel accuracy on the device and host-side meters
(counterpart of ubresnet_tpu/train/metrics.py).

Reference: accuracy() computes per-class and total pixel accuracy from
the channel argmax (train_ubresnet2018_wlarcv2.py:509-566); the larcv1
trainers add a combined track+shower ('nonzero') accuracy (wlarcv1:584);
AverageMeter (val/avg/sum/count) is the universal accumulator.
"""
from __future__ import annotations

from typing import Dict

import torch


def pixel_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   num_classes: int = 3) -> Dict[str, torch.Tensor]:
    """Per-class, total and nonzero (all classes > 0) pixel accuracy, as
    0-d f32 tensors. logits or log-probs (b, h, w, c) — the argmax is
    the same; labels (b, h, w) int."""
    correct = (logits.argmax(-1) == labels).float()
    zero = correct.new_zeros(())
    out: Dict[str, torch.Tensor] = {}
    for c in range(num_classes):
        mask = (labels == c).float()
        n = mask.sum()
        out[f"acc_class{c}"] = torch.where(
            n > 0, (correct * mask).sum() / n.clamp_min(1.0), zero)
    out["acc_total"] = correct.mean()
    nz = (labels > 0).float()
    n_nz = nz.sum()
    out["acc_nonzero"] = torch.where(
        n_nz > 0, (correct * nz).sum() / n_nz.clamp_min(1.0), zero)
    return out


class AverageMeter:
    """val/avg/sum/count accumulator (reference AverageMeter)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __repr__(self):
        return (f"AverageMeter(val={self.val:.4g}, avg={self.avg:.4g}, "
                f"n={self.count})")


class MeterDict:
    """Dict of AverageMeters keyed lazily — per-phase timing/metric set."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = {}

    def update(self, values: Dict[str, float], n: int = 1):
        for k, v in values.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), n)

    def averages(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self):
        for m in self.meters.values():
            m.reset()

    def __getitem__(self, k):
        return self.meters[k]
