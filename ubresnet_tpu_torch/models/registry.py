"""Model registry — name → model class (counterpart of
ubresnet_tpu/models/registry.py). Port models are built from a
reference-format state_dict, which fixes their geometry."""
from __future__ import annotations

from typing import Dict

import torch

from ubresnet_tpu_torch.core.precision import Policy
from ubresnet_tpu_torch.models.aspp_resnet import ASPPResNet, TrainASPPResNet
from ubresnet_tpu_torch.models.uresnet import TrainUResNet, UResNet

# name → (eval class, trainable class)
MODEL_REGISTRY = {"uresnet": (UResNet, TrainUResNet),
                  "aspp_resnet": (ASPPResNet, TrainASPPResNet)}


def arch_of(state_dict: Dict) -> str:
    """The architecture a reference state_dict holds: aspp_resnet when
    any key starts with ``ASPP_layer`` (as the JAX package picks its
    importer, deploy/importers.py:144-148), else uresnet."""
    if any(k.startswith("ASPP_layer") for k in state_dict):
        return "aspp_resnet"
    return "uresnet"


def eval_class_of(model: torch.nn.Module) -> type:
    """The eval class registered beside a trainable model's class."""
    for eval_cls, train_cls in MODEL_REGISTRY.values():
        if isinstance(model, train_cls):
            return eval_cls
    raise KeyError(f"no eval class registered for {type(model).__name__}")


def get_model(name: str, state_dict: Dict[str, torch.Tensor],
              policy: Policy = Policy(), device=None, train: bool = False):
    """Instantiate a registered model on ``device`` (default cuda; the
    CPU only when asked for): the eval model in eval mode, or with
    ``train`` the trainable model in train mode."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; have {sorted(MODEL_REGISTRY)}")
    cls = MODEL_REGISTRY[name][1 if train else 0]
    return cls(state_dict, policy=policy, device=device).train(train)
