"""Device selection (counterpart of ubresnet_tpu/utils/platform.py).

The port runs on the card. The CPU is used only when the caller asks
for it by name (``device="cpu"``, ``--device cpu``, or
``UBTPU_PLATFORM=cpu``, the JAX package's switch, as the default of
the train CLI's ``--device``, which prints the device it resolved); a
missing card is
an error, never a silent fallback. One card per process: a rank of a
distributed run (parallel/distributed.py's env contract) takes
``cuda:{local rank % device_count}``, its index among the ranks on its
host.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Union

import torch

PLATFORM_ENV = "UBTPU_PLATFORM"


def default_device_name() -> str:
    """A CLI's ``--device`` default: "cpu" when ``UBTPU_PLATFORM=cpu``
    asks for it, else "cuda"."""
    return "cpu" if os.environ.get(PLATFORM_ENV) == "cpu" else "cuda"


_local_rank: Optional[int] = None


def set_local_rank(rank: Optional[int]) -> None:
    """This process's index among the ranks on its host, as
    parallel/distributed.py:initialize learns it."""
    global _local_rank
    _local_rank = rank


def process_rank() -> Optional[int]:
    """This process's rank on its host when it is one of a distributed
    run: the local rank once the group is joined, before that the
    launcher's UBTPU_PROCESS_ID (under UBTPU_COORDINATOR); else None."""
    if _local_rank is not None:
        return _local_rank
    if not os.environ.get("UBTPU_COORDINATOR"):
        return None
    return int(os.environ.get("UBTPU_PROCESS_ID", "0"))


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` or ``"cuda[:n]"`` → that CUDA device, raising when
    there is none; a bare "cuda" in a rank of a distributed run is
    ``cuda:{process_rank() % device_count}``; ``"cpu"`` → the CPU.
    Anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu) to run on the CPU"
        )
    rank = process_rank()
    if dev.index is None and rank is not None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def strict_f32():
    """Make float32 mean float32 on the card: cuDNN convolutions
    default to TF32 (about three decimal digits), matmuls do not. The
    f32 reference paths call this before they run."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def strict_f32_scope():
    """strict_f32 for the body only: the settings it found are put back
    after, so the caller's process keeps its own."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    strict_f32()
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
