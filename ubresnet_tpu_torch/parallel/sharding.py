"""Data-parallel sharding of a training over the ranks of a mesh
(counterpart of the data-axis half of ubresnet_tpu/parallel/sharding.py).

The JAX package partitions one jitted step with GSPMD: the batch is
sharded over the mesh's data axis and XLA inserts the reductions (the
gradient psum, the BatchNorm means over the global batch). The port
writes those reductions by hand, one process per card:

  * ``shard_batch``: a rank's share of a global batch;
  * ``shard_state``: the same parameters and BN buffers on every rank
    (broadcast from rank 0, shapes checked), the mesh's group attached
    to every train-mode BatchNorm so it normalises with the global
    batch's moments (models/blocks.py:BatchNorm);
  * ``psum``: a differentiable all-reduce (sum) for those moments,
    whose backward all-reduces the cotangents, so gradients carry the
    cross-rank terms of the global moments;
  * ``all_reduce_grads``: the gradient all-reduce, flattened into one
    buffer, divided by the world size;
  * ``all_true``: one decision on every rank (a MIN all-reduce).

Every rank holds an equal shard (the trainer's per-process batch, or
``shard_batch``), which the moment reductions rely on.
Channel sharding over a model axis (make_param_shardings) and the
spatial shardings wait in ROADMAP queue 1, item 10.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ubresnet_tpu_torch.core.mesh import Mesh


def world_of(group) -> int:
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def shard_batch(batch: dict, mesh: Mesh, accum_steps: int = 1) -> dict:
    """This rank's share of a global ``batch`` (dict of arrays or
    tensors, batch axis first), so that the mesh's ranks together take
    the step one process takes on the whole: with ``accum_steps`` 1 the
    contiguous ``1/data`` of it in rank order (the global batch is the
    concatenation of the ranks' batches, as in JAX's multi-process
    mode); with more, each of the step's microbatches (contiguous
    ``1/accum_steps`` of the global batch) is split so, and the rank's
    pieces are concatenated in microbatch order."""
    n, r = mesh.size, mesh.rank

    def take(x):
        b = x.shape[0]
        if b % (n * accum_steps):
            raise ValueError(f"global batch {b} not divisible by "
                             f"{n} ranks x {accum_steps} microbatches")
        mb, share = b // accum_steps, b // accum_steps // n
        rows = np.concatenate([np.arange(i * mb + r * share,
                                         i * mb + (r + 1) * share)
                               for i in range(accum_steps)])
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(rows, device=x.device)]
        return np.ascontiguousarray(np.asarray(x)[rows])

    return {k: take(v) for k, v in batch.items()}


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def shard_state(state, mesh: Mesh):
    """Make every rank of ``mesh`` hold rank 0's parameters and buffers
    (one flattened broadcast) after checking on every rank that their
    shapes agree, and attach the mesh's group to every BatchNorm of
    ``state.model`` (its ``data_group``). Single-process: only the
    attach (with no group). Returns ``state``."""
    from ubresnet_tpu_torch.models.blocks import BatchNorm

    group = mesh.group
    model = state.model
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_group = group
    if group is None:
        return state
    tensors = list(model.parameters()) + list(model.buffers())
    dev = tensors[0].device
    sig = torch.tensor([len(tensors)] + [t.numel() for t in tensors]
                       + [t.dim() for t in tensors], dtype=torch.float64,
                       device=dev)
    lo, hi = sig.clone(), sig.clone()
    dist.all_reduce(lo, dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, dist.ReduceOp.MAX, group=group)
    if not (torch.equal(lo, sig) and torch.equal(hi, sig)):
        raise ValueError("shard_state: the ranks' models differ in their "
                         "parameter or buffer shapes")
    flat = _flat(tensors)
    dist.broadcast(flat, src=0, group=group)
    with torch.no_grad():
        off = 0
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return state


def psum(t: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``t`` over ``group`` (identity for None):
    torch.distributed.nn.functional.all_reduce, whose backward sums the
    cotangents over the group."""
    if group is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=group)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Average ``.grad`` over ``group`` in place: one all-reduce of the
    gradients flattened into one float32 buffer, divided by the world
    size. A parameter without a gradient contributes zeros, so every
    rank reduces the same buffer."""
    world = world_of(group)
    if group is None:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = _flat(grads)
    dist.all_reduce(flat, group=group)
    flat /= world
    off = 0
    for p in params:
        g = flat[off:off + p.numel()].view_as(p)
        if p.grad is None:
            p.grad = g.to(p.dtype).clone()
        else:
            p.grad.copy_(g)
        off += p.numel()


def all_true(ok: bool, group, device: Optional[torch.device] = None
             ) -> bool:
    """``ok`` of every rank (a MIN all-reduce), so that a decision taken
    on it is the same everywhere."""
    if group is None:
        return ok
    t = torch.tensor([1.0 if ok else 0.0], device=device)
    dist.all_reduce(t, dist.ReduceOp.MIN, group=group)
    return bool(t.item() > 0)
