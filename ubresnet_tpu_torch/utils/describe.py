"""Model introspection, the reference's ``showsizes`` equivalent
(counterpart of ubresnet_tpu/utils/describe.py).

The reference models print every activation shape when constructed
with showsizes=True (ub_uresnet.py:35,90-145; ASPP_ResNet.py:418-521).
Here ``activation_shapes`` captures every submodule's output shape for
an input size (forward hooks, one forward on the model's device),
``describe_model`` tabulates them with each module's type and held
tensor elements, and ``count_params`` counts what the JAX package's
``params`` collection holds.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
from torch import nn

_RUNNING = ("running_mean", "running_var", "num_batches_tracked")


def _shape_of(out) -> Tuple[int, ...]:
    if isinstance(out, torch.Tensor):
        return tuple(out.shape)
    if isinstance(out, (tuple, list)) and out:
        return _shape_of(out[0])
    return ()


def _device_of(model: nn.Module) -> torch.device:
    t = next(iter(model.parameters()), None)
    if t is None:
        t = next(iter(model.buffers()), None)
    return torch.device("cpu") if t is None else t.device


def activation_shapes(
    model: nn.Module, input_shape: Tuple[int, ...] = (1, 512, 512, 1)
) -> Dict[str, Tuple[int, ...]]:
    """Output shape of every submodule (by its qualified name) for a
    zero input of ``input_shape`` (NHWC), and the model's own output
    under ``<output>``."""
    shapes: Dict[str, Tuple[int, ...]] = {}

    def record(name):
        def hook(mod, args, out):  # returns None: the output stands
            shapes.setdefault(name, _shape_of(out))
        return hook

    hooks = [mod.register_forward_hook(record(name))
             for name, mod in model.named_modules() if name]
    try:
        with torch.inference_mode():
            out = model(torch.zeros(input_shape, device=_device_of(model)))
    finally:
        for h in hooks:
            h.remove()
    shapes["<output>"] = _shape_of(out)
    return shapes


def describe_model(
    model: nn.Module, input_shape: Tuple[int, ...] = (1, 512, 512, 1)
) -> str:
    """Layer table: the model and every module two levels down, each
    with its type, output shape and the tensor elements it holds
    (parameters and buffers, folded BN included)."""
    shapes = activation_shapes(model, input_shape)
    rows = [(type(model).__name__, type(model).__name__,
             shapes["<output>"], _held(model))]
    for name, mod in model.named_modules():
        if name and name.count(".") < 2 and name in shapes:
            rows.append((name, type(mod).__name__, shapes[name], _held(mod)))
    head = ("module", "type", "output shape", "elements")
    cells = [head] + [(n, t, str(s), f"{k:,}") for n, t, s, k in rows]
    widths = [max(len(r[i]) for r in cells) for i in range(4)]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in cells]
    lines.insert(1, "  ".join("-" * w for w in widths))
    return "\n".join(lines)


def _held(mod: nn.Module) -> int:
    return sum(t.numel() for t in mod.parameters()) + sum(
        t.numel() for t in mod.buffers())


def count_params(state_dict: Mapping[str, torch.Tensor]) -> int:
    """Elements of the trainable parameters of a reference-format
    state_dict (a trainable model's ``state_dict()`` is one): conv
    kernels and biases, BN scale and bias, not the running statistics,
    as the JAX package's flax ``params`` hold. Not an eval model's
    state_dict: it holds BN folded into its buffers."""
    return sum(v.numel() for k, v in state_dict.items()
               if not k.endswith(_RUNNING))
