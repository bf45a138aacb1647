"""Pixel-weighted negative log-likelihood loss (counterpart of
ubresnet_tpu/losses/pixelwise_nll.py).

Semantics of the reference's training/pixelwise_nllloss.py: per-pixel
NLL of the target class, an optional per-class weight, times a
(b, h, w) pixel-weight image, reduced by a plain mean over every pixel
of the batch. NHWC, class axis last.
"""
from __future__ import annotations

from typing import Optional

import torch


def _gather_class(values: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """values (b, h, w, c) at targets (b, h, w) → (b, h, w); an id
    outside [0, c) gathers 0, as the JAX one-hot contraction does."""
    c = values.shape[-1]
    t = targets.long()
    got = values.gather(-1, t.clamp(0, c - 1).unsqueeze(-1))[..., 0]
    return torch.where((t >= 0) & (t < c), got, torch.zeros_like(got))


def pixelwise_weighted_nll(log_probs: torch.Tensor, targets: torch.Tensor,
                           pixel_weights: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Mean over (b, h, w) of −log p[target] · class_w[target] ·
    pixel_w, from log-softmax input (b, h, w, c)."""
    nll = -_gather_class(log_probs.float(), targets)
    if class_weights is not None:
        nll = nll * class_weights.float().to(nll.device)[targets.long()]
    return (nll * pixel_weights.float()).mean()


def pixelwise_weighted_nll_from_logits(logits: torch.Tensor,
                                       targets: torch.Tensor,
                                       pixel_weights: torch.Tensor,
                                       class_weights: Optional[torch.Tensor]
                                       = None) -> torch.Tensor:
    """The same loss from raw logits: a max shift that carries no
    gradient, logsumexp minus the target's shifted logit."""
    logits = logits.float()
    m = logits.max(-1, keepdim=True).values.detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(-1))
    nll = lse - _gather_class(shifted, targets)
    if class_weights is not None:
        nll = nll * class_weights.float().to(nll.device)[targets.long()]
    return (nll * pixel_weights.float()).mean()
