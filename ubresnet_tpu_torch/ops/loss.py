"""K7 — the training loss: pixel-weighted NLL from raw logits, forward
and backward, and ``weighted_nll``, its differentiable form.

    loss    = mean over pixels of w · (logsumexp(logits) − logits[label])
    dlogits = (softmax(logits) − onehot(label)) · w · g / N

Replaces ubresnet_tpu/ops/pallas_loss.py:pallas_weighted_nll
(_fwd_kernel, _bwd_kernel). Kernels: ops/csrc/weighted_nll.cu —
bytes-bound on the H100; one thread per pixel and stride step, block
sums added across blocks in a fixed order (two passes, no atomics).

Logits (B, H, W, C) f32 NHWC, labels (B, H, W) int32 and weights
(B, H, W) f32, as the JAX kernel takes them. No class weights: the JAX
kernel has none, and the train step refuses both together.
"""
from __future__ import annotations

import torch

from ubresnet_tpu_torch.ops import _build

MAX_BLOCKS = 1024


def _lse(logits):
    m = logits.max(-1, keepdim=True).values
    return m[..., 0] + torch.log(torch.exp(logits - m).sum(-1))


def weighted_nll_fwd_plain(logits, labels, weights):
    """Plain PyTorch version of the forward kernel (f32)."""
    lg = logits.float()
    tgt = lg.gather(-1, labels.long().unsqueeze(-1))[..., 0]
    return ((_lse(lg) - tgt) * weights.float()).sum() / labels.numel()


def weighted_nll_bwd_plain(logits, labels, weights, g):
    """Plain PyTorch version of the backward kernel (f32)."""
    lg = logits.float()
    p = torch.exp(lg - _lse(lg)[..., None])
    onehot = torch.nn.functional.one_hot(labels.long(), lg.shape[-1])
    scale = g.float() / labels.numel()
    return ((p - onehot) * weights.float()[..., None]) * scale


def _check(logits, labels, weights):
    b, h, w, c = logits.shape
    dev = logits.device
    _build.check(logits, "logits", torch.float32, (b, h, w, c), dev)
    _build.check(labels, "labels", torch.int32, (b, h, w), dev)
    _build.check(weights, "weights", torch.float32, (b, h, w), dev)
    if not 1 <= c <= 16:
        raise ValueError(f"weighted_nll kernel takes 1-16 classes, got {c}")
    return b * h * w, c


def weighted_nll_fwd(logits: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """0-d f32 loss. CPU tensors take the plain version; CUDA tensors
    launch the forward kernel of K7."""
    if logits.device.type == "cpu":
        return weighted_nll_fwd_plain(logits, labels, weights)
    n, c = _check(logits, labels, weights)
    blocks = min(-(-n // 256), MAX_BLOCKS)
    part = torch.empty((blocks,), dtype=torch.float32, device=logits.device)
    loss = torch.empty((), dtype=torch.float32, device=logits.device)
    _build.launch("ubr_weighted_nll", [logits, labels, weights, part, loss],
                  [n, c, blocks, float(n)], logits.device)
    weighted_nll_fwd.launches += 1
    return loss


weighted_nll_fwd.launches = 0


def weighted_nll_bwd(logits: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d loss / d logits for loss cotangent ``g`` (0-d f32, read on the
    card by the kernel). CPU tensors take the plain version; CUDA
    tensors launch the backward kernel of K7."""
    if logits.device.type == "cpu":
        return weighted_nll_bwd_plain(logits, labels, weights, g)
    n, c = _check(logits, labels, weights)
    _build.check(g, "g", torch.float32, (), logits.device)
    grad = torch.empty_like(logits)
    _build.launch("ubr_weighted_nll_bwd", [logits, labels, weights, g, grad],
                  [n, c, float(n)], logits.device)
    weighted_nll_bwd.launches += 1
    return grad


weighted_nll_bwd.launches = 0


class _WeightedNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, weights):
        logits = logits.contiguous()
        labels = labels.contiguous()
        weights = weights.float().contiguous()
        ctx.save_for_backward(logits, labels, weights)
        return weighted_nll_fwd(logits, labels, weights)

    @staticmethod
    def backward(ctx, g):
        logits, labels, weights = ctx.saved_tensors
        grad = weighted_nll_bwd(logits, labels, weights, g.contiguous())
        return grad, None, None


def weighted_nll(logits: torch.Tensor, labels: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """Mean over every pixel of −log softmax(logits)[label] · weight."""
    return _WeightedNLL.apply(logits, labels, weights)
