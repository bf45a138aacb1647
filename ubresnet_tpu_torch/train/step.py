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

CUDA graphs. The host's launching of a step's ~4,000 kernels, not the
card, paces an eager step, so where it can (``graph_eligible``: on the
card, no process group, no QAT activation quantizer with a percentile)
the step replays its device work as CUDA graphs. The COO copy and
densify stay eager; densify writes into the step's fixed dense buffers
of the batch's (B, H, W), which the graphs read, so the COO's width can
change from batch to batch. A shape's first step runs the graph's body
eagerly on the capture stream (kernels built, cuDNN's algorithms and
the optimizer state made); its second captures graph A — the BN
buffers' save, each microbatch's forward, loss, backward and metrics
row, the ``accum_steps`` division and the worst |g| a tensor — and
replays it from then on. The guard reads A's flag on the host as the
eager step reads its own; where it passes, graph B, one capture of the
optimizer's update (Adam fused and capturable, its lr a card tensor set
from ``schedule(count)`` before each replay; SGD's captured again when
its lr changes), replays; else the BN buffers are restored eagerly from
A's saved copies. Every graph writes one set of ``.grad`` tensors
(born in the first capture, zeroed and accumulated into by later
shapes' graphs), so B serves them all; the graphs share one memory
pool and are freed with the step. A later capture may place its
tensors where an earlier graph keeps its temporaries, so what the host
reads after B's replay, A's flag and metrics, lives outside the pool
(the shape's first step's tensors). A replay adds its capture's kernel
launches to ``ops.launch_counts``.

Spans of a train step (utils/profiling.py:span, ``id`` the step's
index): ``train.step`` around the call, with ``train.h2d``,
``train.densify``, ``train.bn_save`` (the running buffers' clone), per
microbatch ``train.forward``, ``train.loss`` and ``train.backward``,
then ``train.sync.guard`` (the guard's device→host wait),
``train.optimizer`` (the update, or the skip's BN restore) and
``train.sync.scalars`` (the metrics' device→host copy) inside. On the
graph path ``train.graph.replay`` (id = ``state.step``) takes the place
of ``train.bn_save``, ``train.forward``, ``train.loss`` and
``train.backward``, and ``train.graph.capture`` (the same id) wraps a
capture of A or B.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ubresnet_tpu_torch import ops
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

DENSE = ("image", "label", "weight")
# a capture fails only on what its own thread does: the trainer's
# prefetch thread pins host memory and copies batches meanwhile
CAPTURE_MODE = "thread_local"


@dataclasses.dataclass
class TrainState:
    """What training carries from step to step; the reference
    checkpoint payload {iter, epoch, state_dict, best_prec1, optimizer}
    is (step, model.state_dict(), best_metric, optimizer.state_dict()).
    ``nan_count``: update steps skipped by the non-finite guard;
    ``graph_steps``: steps that ran as a replay of CUDA graphs (neither
    checkpointed)."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    best_metric: float = 0.0
    nan_count: int = 0
    graph_steps: int = 0


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


def graph_eligible(model: torch.nn.Module, device, mesh=None) -> bool:
    """Whether a step of ``model`` runs as CUDA graphs: on the card, on
    a ``mesh`` with no process group (a group's all-reduces and MIN
    guard span ranks), and with no QAT activation fake-quantizer that
    takes a percentile (its calib_batch_range reads the card on the
    host). Remat, the step's and the stages', captures as it runs."""
    grouped = mesh is not None and any(
        g is not None for g in (mesh.group, mesh.data_group, mesh.model_group))
    if torch.device(device).type != "cuda" or grouped:
        return False
    return not any(getattr(m, "qat", False) and getattr(m, "pct", 0)
                   for m in model.modules())


class _Graphs:
    """The graph path of one model and optimizer (the module docstring):
    each batch shape's fixed dense buffers, output buffers and graph A,
    graph B, the gradients they share and their memory pool."""

    def __init__(self, model, opt: Optimizer, microbatch, num_classes: int,
                 accum_steps: int, device: torch.device):
        self.model, self.opt, self.microbatch = model, opt, microbatch
        self.num_classes, self.accum_steps = num_classes, accum_steps
        self.params = list(model.parameters())
        self.running = list(model.buffers())
        self.saved = [b.clone() for b in self.running]
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.inputs = {}  # batch shape → its dense buffers
        # batch shape → its first step's guard flag and metrics vector,
        # which its graph writes: outside the pool, where no later
        # capture can place a tensor of its own
        self.outputs = {}
        self.graphs = {}  # batch shape → (graph A, a replay's launches)
        self.keys = None  # the metrics vector's names
        self.grads = None  # the .grad tensors every graph writes
        self.update = None  # (graph B, what it was captured at)
        self.stepped = False  # an eager update made the optimizer state
        opt.capturable()

    def dense(self, batch: dict, sparse_hw) -> tuple:
        """The batch in its shape's fixed dense buffers → (shape, them)."""
        if sparse_hw is not None:
            key = (batch["img_idx"].shape[0], *sparse_hw)
            dense = densify_batch(batch, tuple(sparse_hw),
                                  self.inputs.get(key))
        else:
            key = tuple((tuple(batch[k].shape), batch[k].dtype)
                        for k in DENSE)
            out = self.inputs.get(key)
            dense = {k: (batch[k].clone() if out is None
                         else out[k].copy_(batch[k])) for k in DENSE}
        self.inputs[key] = dense
        return key, dense

    def _body(self, dense: dict, ok=None, out=None) -> tuple:
        """The device work graph A holds → (ok flag, metrics vector,
        gradients), the first two written into ``ok`` and ``out`` if
        given."""
        with span("train.bn_save"):
            for keep, buf in zip(self.saved, self.running):
                keep.copy_(buf)
        if self.grads is None:
            self.opt.zero_grad()
        else:
            torch._foreach_zero_(self.grads)
        mb = dense["image"].shape[0] // self.accum_steps
        micro = [self.microbatch(self.model, {k: v[i * mb:(i + 1) * mb]
                                              for k, v in dense.items()})
                 for i in range(self.accum_steps)]
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.accum_steps > 1:
            torch._foreach_div_(grads, float(self.accum_steps))
        metrics = _global_metrics(torch.stack(micro), None, self.num_classes)
        # max |g| per tensor carries any inf or NaN through
        worst = torch.stack(torch._foreach_norm(grads, float("inf")))
        ok = torch.logical_and(torch.isfinite(metrics["loss"]),
                               torch.isfinite(worst).all(), out=ok)
        out = torch.stack([m.float() for m in metrics.values()], out=out)
        self.keys = list(metrics)
        return ok, out, grads

    def eager(self, key, dense: dict) -> None:
        """A shape's first step: the body on the capture stream."""
        here = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            self.outputs[key] = self._body(dense)[:2]
        here.wait_stream(self.stream)

    def capture(self, key, dense: dict) -> None:
        before = ops.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode=CAPTURE_MODE):
            _, _, grads = self._body(dense, *self.outputs[key])
        if self.grads is None:
            self.grads = grads
        self.graphs[key] = (graph, {
            k: n - before[k] for k, n in ops.launch_counts().items()
            if n != before[k]})

    def grads_kept(self) -> bool:
        """Whether the parameters still hold the graphs' gradients."""
        have = [p.grad for p in self.params if p.grad is not None]
        return len(have) == len(self.grads) and all(
            a is b for a, b in zip(have, self.grads))

    def step_optimizer(self, step_id: int) -> None:
        """The update: B's replay once the gradients are the graphs' and
        an eager update has made the optimizer's state, else eager."""
        opt = self.opt
        if self.grads is None or not self.stepped:
            opt.step()
            self.stepped = True
            return
        at = (None if opt.lr is not None else opt.schedule(opt.count),
              opt.generation)
        if self.update is None or self.update[1] != at:
            opt.set_lr()
            graph = torch.cuda.CUDAGraph()
            with span("train.graph.capture", step_id), torch.cuda.graph(
                    graph, pool=self.pool, stream=self.stream,
                    capture_error_mode=CAPTURE_MODE):
                opt.opt.step()
            self.update = (graph, at)
        opt.step(self.update[0].replay)

    def restore(self) -> None:
        with torch.no_grad():
            for buf, old in zip(self.running, self.saved):
                buf.copy_(old)


class _TrainStep:
    """``build_train_step``'s step: the graph path where
    ``graph_eligible`` holds for the state's model, else the eager one.
    ``graphs``: the graph path's state for the model and optimizer last
    stepped (None on the eager path)."""

    def __init__(self, eager, make_graphs, device, mesh, sparse_hw):
        self.eager, self.make_graphs = eager, make_graphs
        self.device, self.mesh, self.sparse_hw = device, mesh, sparse_hw
        self.graphs: Optional[_Graphs] = None
        self._for = None  # (model, optimizer) the path was chosen for

    def __call__(self, state: TrainState, batch: dict):
        with span("train.step", state.step):
            model, opt = state.model, state.optimizer
            if self._for is None or self._for[0] is not model \
                    or self._for[1] is not opt:
                self._for = (model, opt)
                self.graphs = (self.make_graphs(model, opt) if graph_eligible(
                    model, self.device, self.mesh) else None)
            if self.graphs is None:
                return self.eager(state, batch)
            return self._graph_step(state, batch)

    def _graph_step(self, state: TrainState, batch: dict):
        g = self.graphs
        if g.grads is not None and not g.grads_kept():
            # the gradients were dropped or replaced: start over
            self.graphs = g = self.make_graphs(state.model, state.optimizer)
        with span("train.h2d"):
            batch = to_device(batch, self.device)
        with span("train.densify"):
            key, dense = g.dense(batch, self.sparse_hw)
        if dense["image"].shape[0] % g.accum_steps:
            raise ValueError(f"batch {dense['image'].shape[0]} not divisible"
                             f" by accum_steps {g.accum_steps}")
        state.model.train()
        if key not in g.outputs:
            g.eager(key, dense)
        else:
            if key not in g.graphs:
                with span("train.graph.capture", state.step):
                    g.capture(key, dense)
            else:
                ops.add_launch_counts(g.graphs[key][1])
            with span("train.graph.replay", state.step):
                g.graphs[key][0].replay()
            state.graph_steps += 1
        ok, out = g.outputs[key]
        with span("train.sync.guard"):
            ok = bool(ok)
        with span("train.optimizer"):
            if ok:
                g.step_optimizer(state.step)
            else:
                g.restore()
                state.nan_count += 1
        state.step += 1
        with span("train.sync.scalars"):
            metrics = dict(zip(g.keys, out.tolist()))
        metrics["nan_skipped"] = state.nan_count
        return state, metrics


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
    global batch's. Where ``graph_eligible`` holds the step replays CUDA
    graphs (the module docstring)."""
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

    def microbatch(model, part: dict) -> torch.Tensor:
        """Forward, loss and backward of one microbatch → its metrics
        row (loss, pixel_counts)."""
        with span("train.forward"):
            if remat:
                logits = remat_call(model, part["image"], logits=True)
            else:
                logits = model(part["image"], logits=True)
        with span("train.loss"):
            loss = loss_impl(logits, part["label"], part["weight"])
        with span("train.backward"):
            loss.backward()
        return torch.cat([
            loss.detach().float().view(1),
            pixel_counts(logits.detach(), part["label"], num_classes)])

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
        micro = [microbatch(model, {k: v[i * mb:(i + 1) * mb]
                                    for k, v in batch.items()})
                 for i in range(accum_steps)]
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

    def make_graphs(model, opt):
        return _Graphs(model, opt, microbatch, num_classes, accum_steps,
                       device)

    return _TrainStep(one_step, make_graphs, device, mesh, sparse_hw)


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
