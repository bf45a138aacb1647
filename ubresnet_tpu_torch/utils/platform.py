"""Device selection (counterpart of ubresnet_tpu/utils/platform.py).

The port runs on the card. The CPU is used only when the caller asks
for it by name; a missing card is an error, never a silent fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` or ``"cuda[:n]"`` → that CUDA device, raising when
    there is none; ``"cpu"`` → the CPU. Anything else raises."""
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
    return dev


def strict_f32():
    """Make float32 mean float32 on the card: cuDNN convolutions
    default to TF32 (about three decimal digits), matmuls do not. The
    f32 reference paths call this before they run."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
