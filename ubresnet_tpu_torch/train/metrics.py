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


def pixel_counts(logits: torch.Tensor, labels: torch.Tensor,
                 num_classes: int = 3) -> torch.Tensor:
    """The counts pixel accuracy is made of, as one f32 vector: per
    class (correct, pixels), then (correct, pixels) over all and over
    the nonzero classes. Counts add over the shards of a batch, so the
    data-parallel step sums them over its ranks (train/step.py) and
    ``accuracy_from_counts`` gives the global batch's accuracies, as
    JAX's are under GSPMD — not the mean of per-rank ratios."""
    correct = (logits.argmax(-1) == labels).float()
    parts = []
    for c in range(num_classes):
        mask = (labels == c).float()
        parts += [(correct * mask).sum(), mask.sum()]
    nz = (labels > 0).float()
    parts += [correct.sum(), correct.new_full((), float(correct.numel())),
              (correct * nz).sum(), nz.sum()]
    return torch.stack(parts)


def accuracy_from_counts(counts: torch.Tensor, num_classes: int = 3
                         ) -> Dict[str, torch.Tensor]:
    """``pixel_counts``' vector (or a sum of them) → acc_class{c},
    acc_total, acc_nonzero as 0-d f32 tensors; a class without pixels
    scores 0."""
    zero = counts.new_zeros(())
    out: Dict[str, torch.Tensor] = {}

    def ratio(i):
        n = counts[i + 1]
        return torch.where(n > 0, counts[i] / n.clamp_min(1.0), zero)

    for c in range(num_classes):
        out[f"acc_class{c}"] = ratio(2 * c)
    out["acc_total"] = ratio(2 * num_classes)
    out["acc_nonzero"] = ratio(2 * num_classes + 2)
    return out


def pixel_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   num_classes: int = 3) -> Dict[str, torch.Tensor]:
    """Per-class, total and nonzero (all classes > 0) pixel accuracy, as
    0-d f32 tensors. logits or log-probs (b, h, w, c) — the argmax is
    the same; labels (b, h, w) int."""
    return accuracy_from_counts(pixel_counts(logits, labels, num_classes),
                                num_classes)


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
