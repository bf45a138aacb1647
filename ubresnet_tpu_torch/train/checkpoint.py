"""Checkpoints in the reference's ``.tar`` form (counterpart of
ubresnet_tpu/train/checkpoint.py, which keeps orbax directories).

Reference behaviour (train_ubresnet2018_wlarcv2.py:253-289,474-479):
periodic save every N iterations, a best-model copy, a final save, and
resume restoring the model, the optimizer and the best metric. A file
is {iter, epoch, state_dict, best_prec1, optimizer}: ``state_dict`` is
the model's reference state_dict (BN running stats included), so
deploy/weights.py:load_reference_checkpoint and the JAX importer read
it; ``optimizer`` is the port optimizer's state (torch state and the
schedule's update count). Files are ``<dir>/step_<N>.tar`` and
``<dir>/best.tar``, each written to a temporary name and renamed into
place. They are pickles: load only checkpoints you trust.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

_STEP = re.compile(r"^step_(\d+)\.tar$")


def _payload(state, epoch: float, whole=None) -> dict:
    sd, osd = whole or (state.model.state_dict(),
                        state.optimizer.state_dict())
    return {
        "iter": state.step,
        "epoch": float(epoch),
        "state_dict": {k: v.detach().cpu() for k, v in sd.items()},
        "best_prec1": float(state.best_metric),
        "optimizer": osd,
    }


def _write(obj, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def checkpoint_path(directory: str, step: int) -> str:
    """<dir>/step_<N>.tar, absolute."""
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}.tar")


def save_checkpoint(directory: str, state, *, best: bool = False,
                    epoch: float = 0.0, whole=None) -> str:
    """Save under <dir>/step_<N>.tar; also refresh <dir>/best.tar when
    ``best``. Returns the step file's path. In a distributed run only
    rank 0 calls this (train/trainer.py). ``whole``: (model state_dict,
    optimizer state_dict) to write instead of the state's own — with a
    model axis, the sharded weights and moments gathered whole
    (parallel/sharding.py:whole_state_dict, whole_optimizer_state), so
    the file is the one a single process writes."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, state.step)
    _write(_payload(state, epoch, whole), path)
    if best:
        tmp = os.path.join(directory, f"best.tar.{os.getpid()}.tmp")
        shutil.copyfile(path, tmp)
        os.replace(tmp, os.path.join(directory, "best.tar"))
    return path


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP.match,
                                               os.listdir(directory)) if m)


def prune_checkpoints(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` step files (best.tar is never
    pruned); keep <= 0 keeps everything, as the reference does."""
    if keep <= 0:
        return
    for step in _steps(directory)[:-keep]:
        os.remove(os.path.join(directory, f"step_{step:08d}.tar"))


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def checkpoint_file(directory: str, *, step: Optional[int] = None,
                    best: bool = False) -> str:
    """The file a restore reads: <dir>/best.tar with ``best``, else
    <dir>/step_<N>.tar of ``step`` or, by default, the newest step.
    Raises FileNotFoundError when there is none."""
    directory = os.path.abspath(directory)
    if best:
        path = os.path.join(directory, "best.tar")
    else:
        step = latest_step(directory) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        path = os.path.join(directory, f"step_{step:08d}.tar")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint {path}")
    return path


def restore_checkpoint(directory: str, state, *, step: Optional[int] = None,
                       best: bool = False):
    """Load a checkpoint (the latest by default) into ``state``: the
    model's parameters and running stats, the optimizer, the step and
    the best metric. The model is whole (with a model axis the trainer
    restores before ``shard_state`` slices it again)."""
    path = checkpoint_file(directory, step=step, best=best)
    payload = torch.load(path, map_location="cpu", weights_only=False)
    state.model.load_state_dict(payload["state_dict"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["iter"])
    state.best_metric = float(payload["best_prec1"])
    return state
