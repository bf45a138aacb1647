"""What every plain reference shares: float32 on the card, the float8
control's rounding, convolution and BatchNorm over a reference-format
state_dict, the loss, Adam, and the eval and training loops that drive
an architecture's ``Net``. What a reference module of an architecture
(``reference/<arch>.py``) has to give is written at the head of
reference/uresnet.py, the first of them.

BatchNorm in training normalises by the batch's biased variance and
moves the running statistics by 0.1 towards the batch's mean and biased
variance. That is the program's stated semantics (flax's BatchNorm,
which the port follows); torch's nn.BatchNorm2d would move the running
variance towards the unbiased one.

``quant`` (the control): every convolution's input and weight are
rounded to float8 e4m3 with one scale a tensor, and the products are
summed in float32; gradients pass the rounding unchanged.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
E4M3_MAX = 448.0

StateDict = Dict[str, torch.Tensor]


def strict_f32() -> None:
    """float32 means float32 on the card: no TF32 in cuDNN or matmuls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its absolute max at
    448), back in float32; the gradient passes unchanged."""
    amax = t.detach().abs().amax().clamp_min(1e-30)
    scale = amax / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


def is_param(key: str) -> bool:
    return not key.endswith(("running_mean", "running_var"))


class Layers:
    """Convolution and BatchNorm over a state_dict ``sd`` (tensors:
    parameters and the BN running statistics), the base of an
    architecture's ``Net``. ``train``: BN uses batch statistics and the
    running statistics in ``sd`` are replaced by their moved values;
    ``momentum``: how far a training step moves them (1: to the batch's);
    ``quant``: the float8 control."""

    def __init__(self, sd: StateDict, train: bool = False,
                 quant: bool = False, momentum: float = BN_MOMENTUM):
        self.sd = sd
        self.train = train
        self.quant = quant
        self.momentum = momentum

    def _q(self, t):
        return fp8_round(t) if self.quant else t

    def conv(self, x, key, stride=1):
        w = self.sd[f"{key}.weight"]
        k = w.shape[-1]
        return F.conv2d(self._q(x), self._q(w), self.sd.get(f"{key}.bias"),
                        stride=stride, padding=k // 2)

    def bn(self, y, key):
        sd = self.sd
        w, b = sd[f"{key}.weight"], sd[f"{key}.bias"]
        if self.train:
            mean = y.mean((0, 2, 3))
            var = y.var((0, 2, 3), unbiased=False)
            with torch.no_grad():
                m = self.momentum
                rm, rv = f"{key}.running_mean", f"{key}.running_var"
                sd[rm] = (1 - m) * sd[rm] + m * mean.detach()
                sd[rv] = (1 - m) * sd[rv] + m * var.detach()
        else:
            mean, var = sd[f"{key}.running_mean"], sd[f"{key}.running_var"]
        inv = torch.rsqrt(var + BN_EPS)
        return ((y - mean.view(1, -1, 1, 1)) * (inv * w).view(1, -1, 1, 1)
                + b.view(1, -1, 1, 1))


def probabilities(net_cls, sd: StateDict, crops: torch.Tensor,
                  chunk: int = 4) -> torch.Tensor:
    """Eval-mode softmax scores of NHWC crops (b, h, w, 1) by
    ``net_cls(sd)``, computed ``chunk`` crops at a time: (b, h, w,
    classes) float32."""
    net = net_cls(sd)
    out = []
    with torch.no_grad():
        for i in range(0, crops.shape[0], chunk):
            x = crops[i:i + chunk].float().permute(0, 3, 1, 2)
            out.append(torch.softmax(net(x), 1).permute(0, 2, 3, 1))
    return torch.cat(out)


def weighted_nll(logits: torch.Tensor, label: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Mean over every pixel of -log softmax(logits)[label] * weight
    (the reference's training/pixelwise_nllloss.py); logits NCHW."""
    logp = torch.log_softmax(logits, 1)
    nll = -logp.gather(1, label.long().unsqueeze(1))[:, 0]
    return (nll * weight).mean()


class Adam:
    """torch.optim.Adam's update written out: L2 weight decay added to
    the gradient, bias-corrected moments, eps outside the square root."""

    def __init__(self, lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The updated parameters; ``grads`` are the loss's gradients
        (the decay is added here)."""
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        out = {}
        for k, p in params.items():
            g = grads[k] + self.wd * p
            m = self.m.get(k, torch.zeros_like(p)) * b1 + (1 - b1) * g
            v = self.v.get(k, torch.zeros_like(p)) * b2 + (1 - b2) * g * g
            self.m[k], self.v[k] = m, v
            denom = v.sqrt() / math.sqrt(c2) + self.eps
            out[k] = p - (self.lr / c1) * m / denom
        return out


def train_steps(net_cls, sd: StateDict, batches, lr: float,
                weight_decay: float, quant: bool = False) -> dict:
    """Adam steps of ``net_cls`` from ``sd`` over ``batches`` ({image (b,
    h, w, 1), label (b, h, w), weight (b, h, w)} tensors on one device),
    one step a batch. Returns the readings the comparison needs:
    ``losses``; ``raw_grad1`` and ``grad1``, the per-leaf norms of the
    first step's loss gradient and of that gradient with the decay added
    (what the optimizer gets); ``sd``, the state after the last step
    (parameters and running statistics)."""
    state = {k: v.detach().clone().float() for k, v in sd.items()}
    opt = Adam(lr, weight_decay)
    losses, raw1, g1 = [], None, None
    for n, b in enumerate(batches):
        params = {k: v.requires_grad_(True) for k, v in state.items()
                  if is_param(k)}
        net = net_cls(dict(state), train=True, quant=quant)
        x = b["image"].float().permute(0, 3, 1, 2)
        loss = weighted_nll(net(x), b["label"], b["weight"].float())
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        losses.append(float(loss.detach()))
        if n == 0:
            raw1 = {k: float(g.norm()) for k, g in grads.items()}
            g1 = {k: float((g + weight_decay * params[k].detach()).norm())
                  for k, g in grads.items()}
        with torch.no_grad():
            new = opt.step({k: p.detach() for k, p in params.items()},
                           grads)
        state = {k: (new[k] if k in new else net.sd[k]).detach()
                 for k in state}
    return {"losses": losses, "raw_grad1": raw1, "grad1": g1, "sd": state}
