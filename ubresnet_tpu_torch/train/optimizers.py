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
schedule(k), as optax.scale_by_schedule counts. ``capturable()`` readies
the update for a CUDA graph (train/step.py): Adam then keeps its step
counts on the card, takes its fused update and reads lr from a 0-d card
tensor that ``set_lr`` fills before each update, so one captured
update serves every lr.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

from ubresnet_tpu_torch.train.schedules import make_schedule


class Optimizer:
    """A torch optimizer stepped at ``schedule(count)``; ``count`` is
    the number of updates applied. Its state_dict holds both, in the
    form an uncaptured optimizer holds them. ``lr``: the 0-d card
    tensor a captured Adam reads (None until ``capturable``);
    ``generation`` rises when ``load_state_dict`` replaces the state
    tensors a captured update reads."""

    def __init__(self, opt: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.opt = opt
        self.schedule = schedule
        self.count = 0
        self.lr: Optional[torch.Tensor] = None
        self.generation = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def set_lr(self) -> float:
        """Put schedule(count) where the next update reads it."""
        lr = self.schedule(self.count)
        if self.lr is not None:
            self.lr.fill_(lr)
        else:
            for group in self.opt.param_groups:
                group["lr"] = lr
        return lr

    def step(self, update: Optional[Callable[[], None]] = None) -> None:
        """One update at schedule(count): ``update`` (the replay of a
        captured ``self.opt.step``) or the torch optimizer's step."""
        self.set_lr()
        (update or self.opt.step)()
        self.count += 1

    def capturable(self) -> None:
        """Ready Adam's update for graph capture: fused and capturable,
        its step counts and lr on the card (the capturable foreach form
        takes beta ** step one launch a tensor). SGD's foreach update
        takes lr as a number, so a graph of it holds the lr it was
        captured at."""
        if self.lr is not None or not isinstance(self.opt, torch.optim.Adam):
            return
        dev = self.opt.param_groups[0]["params"][0].device
        self.lr = torch.full((), self.schedule(self.count),
                             dtype=torch.float32, device=dev)
        self._on_card()
        # the uncaptured updates (a batch shape's first step) are meant
        self.opt._warned_capturable_if_run_uncaptured = True

    def _on_card(self) -> None:
        for group in self.opt.param_groups:
            group.update(capturable=True, fused=True, lr=self.lr)
        for st in self.opt.state.values():
            if "step" in st:
                st["step"] = st["step"].to(self.lr.device, torch.float32)

    def state_dict(self) -> dict:
        sd = self.opt.state_dict()
        if self.lr is not None:  # as an uncaptured Adam holds it
            sd = {"state": {i: {**s, "step": s["step"].cpu()}
                            for i, s in sd["state"].items()},
                  "param_groups": [{**g, "lr": float(self.lr),
                                    "capturable": False, "fused": None}
                                   for g in sd["param_groups"]]}
        return {"torch": sd, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["torch"])
        self.count = int(state["count"])
        if self.lr is not None:
            self._on_card()
        self.generation += 1


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
