"""Optimizers at the reference's semantics (counterpart of
ubresnet_tpu/train/optimizers.py, whose optax chains reproduce these):

  * adam: torch.optim.Adam(lr, weight_decay) — weight decay is L2 added
    to the gradient before the moment updates (not AdamW)
    (train_ubresnet2018_wlarcv2.py:155-157)
  * sgd:  torch.optim.SGD(lr, momentum, weight_decay), dampening 0 —
    heavy-ball momentum, the same as optax.trace
    (train_ubresnet2018_wlarcv1.py:127-129)

``Optimizer`` wraps the torch optimizer with the learning-rate schedule:
update k (counting from 0, applied updates only) runs at lr =
schedule(k), as optax.scale_by_schedule counts.
"""
from __future__ import annotations

from typing import Callable, Iterable, Union

import torch

from ubresnet_tpu_torch.train.schedules import make_schedule


class Optimizer:
    """A torch optimizer stepped at ``schedule(count)``; ``count`` is
    the number of updates applied. Its state_dict holds both."""

    def __init__(self, opt: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.opt = opt
        self.schedule = schedule
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"torch": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["torch"])
        self.count = int(state["count"])


def make_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adam",
                   learning_rate: Union[float, Callable[[int], float]] = 1e-5,
                   weight_decay: float = 0.0,
                   momentum: float = 0.9) -> Optimizer:
    """Adam (betas 0.9/0.999, eps 1e-8, as the reference and optax's
    defaults) or SGD with heavy-ball momentum."""
    schedule = (learning_rate if callable(learning_rate)
                else (lambda step: learning_rate))
    params = list(params)
    lr0 = schedule(0)
    if name == "adam":
        opt = torch.optim.Adam(params, lr=lr0, weight_decay=weight_decay)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=lr0, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer '{name}' (adam|sgd)")
    return Optimizer(opt, schedule)


def optimizer_from_config(optim_cfg, params) -> Optimizer:
    """The optimizer training builds from an OptimConfig."""
    schedule = make_schedule(optim_cfg.schedule, base_lr=optim_cfg.lr,
                             decay_factor=optim_cfg.decay_factor,
                             decay_every=optim_cfg.decay_every)
    return make_optimizer(params, optim_cfg.name, learning_rate=schedule,
                          weight_decay=optim_cfg.weight_decay,
                          momentum=optim_cfg.momentum)
