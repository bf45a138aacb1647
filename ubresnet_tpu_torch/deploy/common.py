"""What the deploy runners share: the score writer for ``.uevt`` or
larcv ``.root`` outputs, and the host↔device transfers of their
pipelines (pinned memory and a CUDA event per copy on the card). Their
input is opened by data/rootio.py:open_event_file (.uevt or .root,
sniffed by magic)."""
from __future__ import annotations

import numpy as np
import torch

from ubresnet_tpu_torch.data.rootio import RootWriter
from ubresnet_tpu_torch.data.uevt import EventFileWriter


def open_score_writer(path: str, score_dtype):
    """(writer, dtype the scores are stored in) for ``path``: a larcv
    ``RootWriter`` for ``.root`` (the reference's IOManager kWRITE
    write-back), which stores float32 whatever ``score_dtype`` asks
    (larcv Image2D is float; JAX deploy/wholeview.py:361-368), else a
    .uevt ``EventFileWriter`` in ``score_dtype``."""
    if path.endswith(".root"):
        return RootWriter(path), np.dtype(np.float32)
    return EventFileWriter(path), np.dtype(score_dtype)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → ``device``: on the card through pinned memory,
    asynchronously."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host_async(dev: torch.Tensor):
    """Enqueue ``dev``'s copy into pinned host memory behind the work
    that produces it: (host tensor, CUDA event to wait on), or (dev,
    None) on the CPU. Nothing waits here."""
    if dev.device.type != "cuda":
        return dev, None
    host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
    host.copy_(dev, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def wait_host(pending) -> torch.Tensor:
    """The host tensor of ``to_host_async``, once its copy landed."""
    host, done = pending
    if done is not None:
        done.synchronize()
    return host
