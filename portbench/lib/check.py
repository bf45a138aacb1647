"""The comparisons that decide ``correct``: the program's outputs against
the plain float32 reference of the configuration's architecture
(``ref``, portbench/reference/<arch>.py), each number beside the limit
its cell file sets.

Scoring: the probabilities the runner handed back for a sample of the
window's batches, against the reference's scores of the same crops:
``mean_abs_dp``, the mean gap over every pixel and class;
``worst_crop_dp``, that mean over one crop, for the worst crop; and
``max_abs_dp``, the widest gap of any pixel's class probability.

Training: the first three steps of the window's step object against
three reference steps from the same weights on the same batches:
``loss_gap`` (the largest relative gap of a step's loss);
``grad1_gap`` (the first step's gradient as Adam gets it, read back
from the first moment after one step) and ``update3_gap`` (each
parameter's change after three steps) by the worst leaf: the gap
between the program's norm of the leaf and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is
larger; ``bnstat3_gap`` the same for the BN running statistics' change;
each also as ``<name>_median``, the median leaf's gap.
Leaves whose loss gradient in the reference is under a thousandth of
the median leaf's (the conv biases that a BatchNorm follows: their
gradient is zero but for rounding, and Adam moves them by round-off
alone) are left out of the gradient and the change.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference.shared import strict_f32

SMALL_GRAD = 1e-3


def score_numbers(ref, sd, sample: List[Tuple[np.ndarray, np.ndarray]],
                  device) -> Dict[str, float]:
    """``sample``: (crops (b, h, w, 1), the program's probabilities (b, h,
    w, c)) pairs. Scores of the reference module ``ref`` on ``device`` in
    float32, TF32 off."""
    strict_f32()
    worst, crop, total, count = 0.0, 0.0, 0.0, 0
    for crops, probs in sample:
        want = ref.probabilities(sd, torch.from_numpy(crops).to(device))
        got = torch.from_numpy(np.ascontiguousarray(probs)).to(device)
        d = (got.float() - want).abs()
        worst = max(worst, float(d.max()))
        crop = max(crop, float(d.flatten(1).double().mean(1).max()))
        total += float(d.double().sum())
        count += d.numel()
    return {"max_abs_dp": worst, "mean_abs_dp": total / max(count, 1),
            "worst_crop_dp": crop}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               keys) -> Dict[str, float]:
    """{leaf: gap}; a leaf the program lacks (an optimizer that never
    stepped keeps no moment) reads as norm 0."""
    keys = [k for k in keys if k in want]
    if not keys:
        return {"": 0.0}
    med = statistics.median(want[k] for k in keys)
    return {k: abs(got.get(k, 0.0) - want[k]) / max(want[k], med, 1e-30)
            for k in keys}


def train_numbers(prog: dict, want: dict) -> Dict[str, float]:
    """``prog``: the program's readings (``losses``, ``grad1``,
    ``update3``, ``bnstat3``: per-leaf norms); ``want`` the reference's
    (``train_readings``)."""
    raw = want["raw_grad1"]
    med = statistics.median(raw.values())
    kept = [k for k, v in raw.items() if v >= SMALL_GRAD * med]
    losses = zip(prog["losses"], want["losses"])
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in losses)}
    for name, keys in (("grad1", kept), ("update3", kept),
                       ("bnstat3", list(want["bnstat3"]))):
        gaps = _leaf_gaps(prog[name], want[name], keys)
        worst = max(gaps, key=gaps.get)
        out[f"{name}_gap"] = gaps[worst]
        out[f"{name}_gap_median"] = statistics.median(gaps.values())
        out[f"{name}_worst_leaf"] = worst
    return out


def train_readings(ref, sd0, batches, lr: float, weight_decay: float,
                   quant: bool = False) -> dict:
    """The readings of the reference module ``ref`` over ``batches``
    (dense, on the device) from ``sd0``: losses, raw and Adam-side first
    gradients, and each leaf's change after the last step."""
    strict_f32()
    out = ref.train_steps(sd0, batches, lr, weight_decay, quant=quant)
    sd = out["sd"]
    params = {k: float((sd[k] - sd0[k]).norm()) for k in sd
              if ref.is_param(k)}
    stats = {k: float((sd[k] - sd0[k]).norm()) for k in sd
             if not ref.is_param(k)}
    return {"losses": out["losses"], "raw_grad1": out["raw_grad1"],
            "grad1": out["grad1"], "update3": params, "bnstat3": stats}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(every limited number within its limit, {name: {value, limit}});
    a number that is not finite fails."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(bool(np.isfinite(c["value"])) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
