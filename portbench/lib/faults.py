"""Faults planted under the timed path, each of which a cell's
comparison has to catch (portbench/tests/test_portbench_faults.py on
the CPU; portbench/tools/controls.py reads them on the card):

* ``score_half``: half of each batch left out (its crops scored as
  empty crops);
* ``score_altered``: an answer altered where it is produced (the first
  crop's background and shower scores swapped);
* ``train_unchanged``: a step that returns its state unchanged (the
  optimizer never updates);
* ``train_half``: half of each batch left out, the loss's mean taken
  over the rest.
"""
from __future__ import annotations

import contextlib

FAULTS = {"score": ("score_half", "score_altered"),
          "train": ("train_unchanged", "train_half")}


@contextlib.contextmanager
def planted(name: str):
    from ubresnet_tpu_torch.deploy.precropped import PrecroppedRunner
    from ubresnet_tpu_torch.train import step as step_mod
    from ubresnet_tpu_torch.train.optimizers import Optimizer

    if name == "score_half":
        owner, attr = PrecroppedRunner, "_dispatch"
        orig = owner._dispatch

        def fake(self, batch):
            batch = batch.copy()
            batch[batch.shape[0] // 2:] = 0.0
            return orig(self, batch)
    elif name == "score_altered":
        owner, attr = PrecroppedRunner, "_fetch_one"
        orig = owner._fetch_one

        def fake(self, pending, n, hw):
            out = orig(self, pending, n, hw).copy()
            out[0, ..., [0, 1]] = out[0, ..., [1, 0]]
            return out
    elif name == "train_unchanged":
        owner, attr = Optimizer, "step"

        def fake(self):
            return None
    elif name == "train_half":
        owner, attr = step_mod, "densify_batch"
        orig = step_mod.densify_batch

        def fake(sp, hw):
            dense = orig(sp, hw)
            half = dense["image"].shape[0] // 2
            return {k: v[:half] for k, v in dense.items()}
    else:
        raise ValueError(f"unknown fault {name!r}")
    saved = getattr(owner, attr)
    setattr(owner, attr, fake)
    try:
        yield
    finally:
        setattr(owner, attr, saved)
