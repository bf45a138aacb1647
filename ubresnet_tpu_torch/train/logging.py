"""Scalar logging: JSONL always; TensorBoard when available (counterpart
of ubresnet_tpu/train/logging.py).

Reference: tensorboardX SummaryWriter with grouped scalars
(train_ubresnet2018_wlarcv2.py:79,390-394,463-467). The JSONL stream
is the source of truth; TensorBoard is an add-on when its package is
present. A writer without ``log_dir`` writes nothing: in a distributed
run the trainer gives one only to rank 0.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class ScalarWriter:
    def __init__(self, log_dir: Optional[str] = None, run_name: str = "run"):
        self.log_dir = log_dir
        self._jsonl = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, f"{run_name}.jsonl"), "a")
            self._tb = _try_tensorboard(os.path.join(log_dir, run_name))

    def add_scalar(self, tag: str, value: float, step: int):
        if self._jsonl:
            self._jsonl.write(json.dumps({"t": time.time(), "step": step,
                                          "tag": tag,
                                          "value": float(value)}) + "\n")
            self._jsonl.flush()
        if self._tb:
            self._tb.add_scalar(tag, float(value), step)

    def add_scalars(self, prefix: str, values: Dict[str, float], step: int):
        for k, v in values.items():
            self.add_scalar(f"{prefix}/{k}", v, step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()


def _try_tensorboard(path: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(path)
