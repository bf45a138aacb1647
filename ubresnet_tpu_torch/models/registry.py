"""Model registry — name → model class (counterpart of
ubresnet_tpu/models/registry.py). Port models are built from a
reference-format state_dict, which fixes their geometry."""
from __future__ import annotations

from typing import Dict

import torch

from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.models.uresnet import UResNet

MODEL_REGISTRY = {"uresnet": UResNet}


def get_model(name: str, state_dict: Dict[str, torch.Tensor],
              policy: Policy = Policy(), device=None):
    """Instantiate a registered model on ``device`` (default cuda; the
    CPU only when asked for), in eval mode."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](state_dict, policy=policy,
                                device=device).eval()
