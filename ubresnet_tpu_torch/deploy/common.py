"""What the deploy runners share: event-file I/O with the one refusal
of larcv ``.root`` files, and the host↔device transfers of their
pipelines (pinned memory and a CUDA event per copy on the card)."""
from __future__ import annotations

import numpy as np
import torch

from ubresnet_tpu_torch.data.uevt import MAGIC, EventFileReader

ROOT_IO = ("larcv ROOT (.root) input and output are not ported yet "
           "(ROADMAP queue 1 items 3 and 5): the port reads and writes "
           ".uevt only")


def open_event_file(path: str) -> EventFileReader:
    """Open a .uevt event file; a ``.root`` file raises."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == b"root" or path.endswith(".root"):
        raise NotImplementedError(f"{path}: {ROOT_IO}")
    if head != MAGIC:
        raise ValueError(f"{path}: not a UEVT file")
    return EventFileReader(path)


def check_output(path: str) -> None:
    """Refuse a ``.root`` output path before anything is written."""
    if path.endswith(".root"):
        raise NotImplementedError(f"{path}: {ROOT_IO}")


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
