"""Learning-rate schedules the reference uses (counterpart of
ubresnet_tpu/train/schedules.py): a function of the number of updates
already applied.

  * constant — the flagship trainer's adjust_learning_rate is a no-op
    (train_ubresnet2018_wlarcv2.py:500-507)
  * step     — the grid trainers' base_lr · factor ** (step // every)
    (grid_scripts/train_ubresnet_wlarcv1_tuftsgrid.py:610-619)
"""
from __future__ import annotations

from typing import Callable


def make_schedule(name: str = "constant", base_lr: float = 1e-5,
                  decay_factor: float = 0.1,
                  decay_every: int = 10000) -> Callable[[int], float]:
    if name == "constant":
        return lambda step: base_lr
    if name == "step":
        return lambda step: base_lr * decay_factor ** (step // decay_every)
    raise ValueError(f"unknown schedule '{name}' (constant|step)")
