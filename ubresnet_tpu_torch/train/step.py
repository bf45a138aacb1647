"""Train and eval steps (counterpart of ubresnet_tpu/train/step.py).

The reference's training iteration (train_ubresnet2018_wlarcv2.py:
319-396: forward → PixelWiseNLLLoss → backward → optimizer step →
accuracy meters) as one call on the card: the step densifies a sparse
batch on the device, runs forward and backward (``accum_steps``
microbatches, gradients averaged before one update), and updates the
parameters unless the loss or any gradient is non-finite — then it
skips the whole update: parameters, optimizer state and the BN running
stats, which the forward already moved, are left as they were
(step.py:187-212 of the JAX package). Checking that needs the result
on the host: the step synchronises once, where the JAX step keeps the
check on the device.

Data-parallel (``mesh``, core/mesh.py, with parallel/sharding.py:
shard_state on the state): each rank steps on its shard; BatchNorm
normalises with the global batch's moments (models/blocks.py), the
gradients are all-reduced and divided by the world size after backward
(and after ``accum_steps`` microbatches) — the loss is a per-pixel mean
over equal shards, so that is the global mean's gradient — the loss and
the accuracy counts are summed over the ranks, and the non-finite guard
decides once for all of them (a MIN all-reduce), so no rank updates
where another skips. The reductions are written in the step, not
through DistributedDataParallel's hooks, which would not compose with
the microbatch loop, whole-forward remat and the guard; overlapping
the gradient all-reduce with backward is left to a later change.

With a model axis (``mesh.model_size`` > 1) the ranks of one data index
hold the same shard and the same replicated parameters, and each its
slice of the sharded weights (parallel/sharding.py); the gradients,
loss and metrics are reduced over the data group (the ranks of the
same model index), so each data index counts once, and the guard over
the whole world, since a sharded slice's gradient lives on one rank.

``build_train_step`` and ``build_eval_step`` run on the card unless
``device="cpu"`` is passed; without a card they raise.

Spans of a train step (utils/profiling.py:span, ``id`` the step's
index): ``train.step`` around the call, with ``train.h2d``,
``train.densify``, ``train.bn_save`` (the running buffers' clone), per
microbatch ``train.forward``, ``train.loss`` and ``train.backward``,
then ``train.sync.guard`` (the guard's device→host wait),
``train.optimizer`` (the update, or the skip's BN restore) and
``train.sync.scalars`` (the metrics' device→host copy) inside.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ubresnet_tpu_torch.losses import pixelwise_weighted_nll_from_logits
from ubresnet_tpu_torch.models.blocks import remat as remat_call
from ubresnet_tpu_torch.ops import loss as loss_ops
from ubresnet_tpu_torch.ops.sparse import densify_batch
from ubresnet_tpu_torch.parallel.sharding import (
    all_reduce_grads,
    all_true,
    psum,
    world_of,
)
from ubresnet_tpu_torch.train.metrics import (
    accuracy_from_counts,
    pixel_counts,
)
from ubresnet_tpu_torch.train.optimizers import Optimizer
from ubresnet_tpu_torch.utils.platform import resolve_device
from ubresnet_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    """What training carries from step to step; the reference
    checkpoint payload {iter, epoch, state_dict, best_prec1, optimizer}
    is (step, model.state_dict(), best_metric, optimizer.state_dict()).
    ``nan_count``: update steps skipped by the non-finite guard (not
    checkpointed)."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    best_metric: float = 0.0
    nan_count: int = 0


def create_train_state(model: torch.nn.Module,
                       optimizer: Optimizer) -> TrainState:
    return TrainState(model=model, optimizer=optimizer)


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays or tensors → tensors on ``device`` (asynchronous
    from pinned host memory)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(device, non_blocking=True)
    return out


def _global_metrics(per: torch.Tensor, group, num_classes: int) -> dict:
    """Rows of (loss, pixel_counts) — one per microbatch — summed over
    ``group`` (the loss divided by its ranks: a mean over equal shards)
    → metrics, each the mean over the rows of its global value, as JAX
    averages its microbatches' metrics."""
    if group is not None:
        per = psum(per, group)
        per = torch.cat([per[:, :1] / world_of(group), per[:, 1:]], dim=1)
    rows = [{"loss": row[0], **accuracy_from_counts(row[1:], num_classes)}
            for row in per]
    return {k: torch.stack([r[k] for r in rows]).mean() for k in rows[0]}


def _scalars(metrics: dict) -> dict:
    """0-d tensors → Python floats with one device→host copy."""
    keys = list(metrics)
    vals = torch.stack([metrics[k].float() for k in keys]).tolist()
    return dict(zip(keys, vals))


def build_train_step(num_classes: int = 3,
                     class_weights: Optional[Sequence[float]] = None,
                     use_pallas_loss: bool = False,
                     sparse_hw: Optional[tuple] = None,
                     accum_steps: int = 1, remat: bool = False,
                     device=None, mesh=None):
    """Returns step(state, batch) -> (state, metrics).

    batch: image (b, h, w, c) f32, label (b, h, w) int32, weight
    (b, h, w) f32 — numpy or tensors — or, with ``sparse_hw``, the
    sparse transfer form of ops/sparse.py:sparsify_batch. metrics
    (floats): loss, acc_class{c}, acc_total, acc_nonzero (means over
    the microbatches) and nan_skipped, the run's count of skipped
    updates. ``use_pallas_loss`` takes the loss kernel K7 (which has no
    class weights) for the loss and its gradient. ``remat`` recomputes
    the whole forward in backward (the JAX step's jax.checkpoint,
    models/blocks.py:remat): per step the forward's kernels launch
    twice, the loss's once. ``mesh``: step this rank's shard of a
    data-parallel batch (the module docstring); the metrics are the
    global batch's."""
    device = resolve_device(device)
    group = None if mesh is None else mesh.data_group
    world = None if mesh is None else mesh.group
    if use_pallas_loss and class_weights is not None:
        raise NotImplementedError(
            "the loss kernel (K7) does not take class_weights")
    cw = (None if class_weights is None else
          torch.as_tensor(np.asarray(class_weights, np.float32),
                          device=device))

    def loss_impl(logits, labels, weights):
        if use_pallas_loss:
            return loss_ops.weighted_nll(logits, labels, weights)
        return pixelwise_weighted_nll_from_logits(logits, labels, weights, cw)

    def step(state: TrainState, batch: dict):
        with span("train.step", state.step):
            return one_step(state, batch)

    def one_step(state: TrainState, batch: dict):
        with span("train.h2d"):
            batch = to_device(batch, device)
        if sparse_hw is not None:
            with span("train.densify"):
                batch = densify_batch(batch, tuple(sparse_hw))
        model, opt = state.model, state.optimizer
        model.train()
        running = list(model.buffers())
        with span("train.bn_save"):
            saved = [b.clone() for b in running]
        b = batch["image"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps "
                             f"{accum_steps}")
        mb = b // accum_steps
        opt.zero_grad()
        micro = []
        for i in range(accum_steps):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            with span("train.forward"):
                if remat:
                    logits = remat_call(model, part["image"], logits=True)
                else:
                    logits = model(part["image"], logits=True)
            with span("train.loss"):
                loss = loss_impl(logits, part["label"], part["weight"])
            with span("train.backward"):
                loss.backward()
            micro.append(torch.cat([
                loss.detach().float().view(1),
                pixel_counts(logits.detach(), part["label"], num_classes)]))
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        if accum_steps > 1:
            torch._foreach_div_(grads, float(accum_steps))
        if group is not None:
            all_reduce_grads(model.parameters(), group)
            grads = [p.grad for p in model.parameters()]
        metrics = _global_metrics(torch.stack(micro), group, num_classes)
        # max |g| per tensor carries any inf or NaN through
        worst = torch.stack(torch._foreach_norm(grads, float("inf")))
        with span("train.sync.guard"):
            ok = all_true(bool(torch.isfinite(metrics["loss"])
                               & torch.isfinite(worst).all()), world, device)
        with span("train.optimizer"):
            if ok:
                opt.step()
            else:
                with torch.no_grad():
                    for buf, old in zip(running, saved):
                        buf.copy_(old)
                state.nan_count += 1
        state.step += 1
        with span("train.sync.scalars"):
            out = _scalars(metrics)
        out["nan_skipped"] = state.nan_count
        return state, out

    return step


def build_eval_step(num_classes: int = 3,
                    class_weights: Optional[Sequence[float]] = None,
                    device=None, mesh=None):
    """Returns step(state, batch) -> metrics: the eval model the
    registry pairs with the trained model's class, built from the live
    state_dict (running-stats BN folded, the eval kernel
    zone under the model's policy), then the plain loss and the
    accuracies, no update; with ``mesh``, the global batch's. With a
    model axis the sharded weights are gathered whole first (every rank
    of a model group calls the step)."""
    from ubresnet_tpu_torch.models.registry import eval_class_of
    from ubresnet_tpu_torch.parallel.sharding import whole_state_dict

    device = resolve_device(device)
    group = None if mesh is None else mesh.data_group
    cw = (None if class_weights is None else
          torch.as_tensor(np.asarray(class_weights, np.float32),
                          device=device))

    def step(state: TrainState, batch: dict) -> dict:
        batch = to_device(batch, device)
        sd = whole_state_dict(state.model)
        with torch.inference_mode():
            model = eval_class_of(state.model)(
                sd, policy=state.model.policy, device=device)
            logits = model(batch["image"], logits=True)
            loss = pixelwise_weighted_nll_from_logits(
                logits, batch["label"], batch["weight"], cw)
            per = torch.cat([loss.float().view(1), pixel_counts(
                logits, batch["label"], num_classes)])
            return _scalars(_global_metrics(per[None], group, num_classes))

    return step
