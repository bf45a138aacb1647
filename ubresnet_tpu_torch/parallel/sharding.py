"""Sharding of the port's work over devices and ranks (counterpart of
ubresnet_tpu/parallel/sharding.py).

The JAX package partitions one jitted program with GSPMD: it declares
shardings and XLA inserts the collectives and the conv halo exchanges.
The port writes them by hand.

The data axis of a training, one process per card (core/mesh.py):

  * ``shard_batch``: a data index's share of a global batch;
  * ``shard_state``: the same parameters and BN buffers on every rank
    (broadcast from rank 0, shapes checked), the data group attached
    to every train-mode BatchNorm so it normalises with the global
    batch's moments (models/blocks.py:BatchNorm);
  * ``psum``: a differentiable all-reduce (sum) for those moments,
    whose backward all-reduces the cotangents, so gradients carry the
    cross-rank terms of the global moments;
  * ``all_reduce_grads``: the gradient all-reduce, flattened into one
    buffer, divided by the group's size;
  * ``all_true``: one decision on every rank (a MIN all-reduce).

The model axis (channel sharding, JAX's ``make_param_shardings``): a
conv or deconv weight with ``min_features`` or more output channels
that divide by the model axis keeps only this rank's slice of them, and
of its optimizer moments (``shard_state``). Its layer computes those
output channels and all-gathers them over the model group
(``ModelShard``), whose ranks hold the same data; the input gradient
is summed over the model group. ``whole_state_dict`` and
``whole_optimizer_state`` put the whole weights and moments back
together for a checkpoint or an eval model.

Whole planes row-sharded over devices (JAX's ``plane_sharding`` and
``spatial_sharding``), in one process over a list of devices:
``row_split`` cuts a padded (b, h, w, c) plane into row slabs that
begin at multiples of ``SPATIAL_DIVISOR``, one per device (empty where
there are more devices than 32-row blocks); ``halo_apply`` runs one
stage of a network on every slab with ``halo`` rows of its neighbours
and keeps the rows it owns; ``row_gather`` puts the plane back on one
device.

Every data index holds an equal shard (the trainer's per-process batch,
or ``shard_batch``), which the moment reductions rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ubresnet_tpu_torch.core.mesh import Mesh

# UResNet and ASPP-ResNet downsample by 2^5 (stem pool + four stride-2
# encoders): whole planes pad to this, and row slabs begin at its
# multiples, so every stride-2 stage samples the rows the one-device
# forward samples
SPATIAL_DIVISOR = 32


def world_of(group) -> int:
    """Ranks in ``group`` (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def shard_batch(batch: dict, mesh: Mesh, accum_steps: int = 1) -> dict:
    """This rank's data index's share of a global ``batch`` (dict of
    arrays or tensors, batch axis first), so that the mesh's data
    indices together take the step one process takes on the whole: with
    ``accum_steps`` 1 the contiguous ``1/data`` of it in data-index
    order (the global batch is the concatenation of the data indices'
    batches, as in JAX's multi-process mode); with more, each of the
    step's microbatches (contiguous ``1/accum_steps`` of the global
    batch) is split so, and the pieces are concatenated in microbatch
    order. The ranks of one model group get the same share."""
    n, r = mesh.data_size, mesh.data_rank

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


# ------------------------------------------------------------ model axis


class _GatherSlices(torch.autograd.Function):
    """All-gather ``t`` over ``group`` and concatenate the slices along
    ``dim`` in group-rank order; backward keeps this rank's slice of the
    cotangent, which every rank of the group holds whole (they compute
    the same thing downstream)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.dim, ctx.size = dim, t.shape[dim]
        ctx.rank = dist.get_rank(group)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size)
                .contiguous(), None, None)


class _SumGrads(torch.autograd.Function):
    """Identity forward; backward sums the cotangent over ``group``: the
    input of a layer whose ranks each compute a slice of its output
    channels gets every slice's part of its gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclasses.dataclass
class ModelShard:
    """A weight sharded by output channel over a model group: this rank
    (``rank`` of ``size``) holds slice ``rank`` along ``dim`` (0 for a
    Conv2d's (co, ci, k, k), 1 for a ConvTranspose2d's (ci, co, k, k))."""

    group: object
    size: int
    rank: int
    dim: int

    def gather(self, t: torch.Tensor, dim: Optional[int] = None
               ) -> torch.Tensor:
        """The slices of every rank along ``dim`` (default the weight's),
        under autograd: this rank's slice of the cotangent flows back."""
        return _GatherSlices.apply(t, self.group,
                                   self.dim if dim is None else dim)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the input of this rank's slice of the layer: its
        gradient is summed over the model group."""
        return _SumGrads.apply(x, self.group)


def _sharded_layers(model):
    """(parameter name, module, output-channel dim) of every conv and
    deconv weight of ``model``."""
    from ubresnet_tpu_torch.models.blocks import Conv, TrainDeconv2x

    for name, mod in model.named_modules():
        if isinstance(mod, (Conv, TrainDeconv2x)):
            yield (f"{name}.weight", mod,
                   1 if isinstance(mod, TrainDeconv2x) else 0)


def make_param_shardings(model, mesh: Mesh, min_features: int = 256
                         ) -> Dict[str, int]:
    """JAX's rule (sharding.py:make_param_shardings): {reference key:
    output-channel dim} of every conv or deconv weight with at least
    ``min_features`` output channels that divide by the model axis;
    every other parameter and buffer is replicated. Empty with one
    model rank."""
    m = mesh.model_size
    if m == 1:
        return {}
    out = {}
    for key, mod, dim in _sharded_layers(model):
        co = mod.weight.shape[dim]
        if co >= min_features and co % m == 0:
            out[key] = dim
    return out


def shard_state(state, mesh: Mesh, min_features: int = 256):
    """Make every rank of ``mesh`` hold rank 0's parameters and buffers
    (one flattened broadcast) after checking on every rank that their
    shapes agree, attach the data group to every BatchNorm of
    ``state.model`` (its ``data_group``), and, with a model axis, keep
    this rank's slice of every weight ``make_param_shardings`` shards
    and of its optimizer moments, its layer computing those output
    channels (``model_shard``). Single-process: only the attach (with no
    group). Returns ``state``."""
    from ubresnet_tpu_torch.models.blocks import BatchNorm

    group = mesh.group
    model = state.model
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.data_group = mesh.data_group
    if group is None:
        if mesh.model_size > 1:
            raise ValueError("shard_state: a model axis needs a process "
                             "group (parallel/distributed.initialize)")
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
    if mesh.model_size > 1:
        _slice_state(state, mesh, min_features)
    return state


def _shards(model):
    """{id(weight): (key, its ModelShard)} of the sharded weights."""
    return {id(mod.weight): (key, mod.model_shard)
            for key, mod, _ in _sharded_layers(model)
            if getattr(mod, "model_shard", None) is not None}


def whole_state_dict(model) -> dict:
    """``model.state_dict()`` with every sharded weight gathered whole
    over its model group: the reference state_dict one process holds.
    Collective: every rank of a model group calls it."""
    sd = model.state_dict()
    shards = _shards(model)
    if not shards:
        return sd
    sd = dict(sd)
    with torch.no_grad():
        for key, shard in shards.values():
            sd[key] = shard.gather(sd[key])
    return sd


def whole_optimizer_state(state) -> dict:
    """``state.optimizer.state_dict()`` with the moments of every sharded
    weight gathered whole, as one process's optimizer holds them.
    Collective, as ``whole_state_dict``."""
    opt = state.optimizer
    osd = opt.state_dict()
    shards = _shards(state.model)
    if not shards:
        return osd
    params = [p for g in opt.opt.param_groups for p in g["params"]]
    moments = osd["torch"]["state"]
    with torch.no_grad():
        for i, p in enumerate(params):
            if id(p) not in shards or i not in moments:
                continue
            shard = shards[id(p)][1]
            moments[i] = {k: shard.gather(v) if torch.is_tensor(v)
                          and v.shape == p.shape else v
                          for k, v in moments[i].items()}
    return osd


def _slice_state(state, mesh: Mesh, min_features: int = 256) -> None:
    """Keep this rank's slice of every weight ``make_param_shardings``
    shards, and of its optimizer moments, and mark its layer
    (``model_shard``); the rest stays whole."""
    specs = make_param_shardings(state.model, mesh, min_features)
    opt_state = state.optimizer.opt.state
    for key, mod, dim in _sharded_layers(state.model):
        if key not in specs:
            continue
        p = mod.weight
        n, full = p.shape[dim] // mesh.model_size, p.shape
        lo = mesh.model_rank * n
        with torch.no_grad():
            p.data = p.data.narrow(dim, lo, n).clone()
            for k, v in opt_state.get(p, {}).items():
                if torch.is_tensor(v) and v.shape == full:
                    opt_state[p][k] = v.narrow(dim, lo, n).clone()
        mod.model_shard = ModelShard(mesh.model_group, mesh.model_size,
                                     mesh.model_rank, dim)


def param_state_bytes(state) -> int:
    """Bytes of this rank's parameters plus their optimizer moments (the
    optimizer's per-parameter tensors of the parameter's shape)."""
    total = 0
    opt_state = state.optimizer.opt.state
    for p in state.model.parameters():
        n = 1 + sum(1 for v in opt_state.get(p, {}).values()
                    if torch.is_tensor(v) and v.shape == p.shape)
        total += n * p.numel() * p.element_size()
    return total


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


# --------------------------------------------------------- spatial rows


def row_bounds(h: int, n: int, divisor: int = SPATIAL_DIVISOR
               ) -> List[int]:
    """Row boundaries of ``n`` slabs of an ``h``-row plane (a multiple
    of ``divisor``): whole ``divisor``-row blocks, as even as they go,
    the first slabs taking one more; slabs past the block count are
    empty."""
    if h % divisor:
        raise ValueError(f"{h} rows are not a multiple of {divisor}")
    per, extra = divmod(h // divisor, n)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + (per + (i < extra)) * divisor)
    return bounds


@dataclasses.dataclass
class RowSlabs:
    """A (b, h, w, c) tensor split by rows: ``parts[i]`` holds rows
    ``bounds[i]:bounds[i + 1]`` of it on ``devices[i]`` (None where that
    is empty). ``halo`` counts what the stages copied between slabs
    (rows and bytes), shared by every RowSlabs of one forward."""

    parts: List[Optional[torch.Tensor]]
    bounds: List[int]
    devices: List[torch.device]
    halo: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"rows": 0, "bytes": 0})

    @property
    def height(self) -> int:
        return self.bounds[-1]

    @property
    def width(self) -> int:
        return next(p for p in self.parts if p is not None).shape[2]

    def owned(self) -> List[int]:
        """Indices of the non-empty slabs."""
        return [i for i, p in enumerate(self.parts) if p is not None]

    def map(self, fn: Callable) -> "RowSlabs":
        """``fn`` on every non-empty slab, a row-wise op (no halo)."""
        return dataclasses.replace(self, parts=[
            None if p is None else fn(p) for p in self.parts])


def row_split(x: torch.Tensor, devices: Sequence, divisor: int =
              SPATIAL_DIVISOR) -> RowSlabs:
    """``x`` (b, h, w, c), h a multiple of ``divisor``, as row slabs on
    ``devices`` (one each, ``row_bounds``), each copied to its device."""
    devices = [torch.device(d) for d in devices]
    bounds = row_bounds(x.shape[1], len(devices), divisor)
    parts = [x[:, a:b].to(d).contiguous() if b > a else None
             for a, b, d in zip(bounds, bounds[1:], devices)]
    return RowSlabs(parts, bounds, devices)


def row_gather(slabs: RowSlabs, device) -> torch.Tensor:
    """The slabs concatenated by rows on ``device``."""
    return torch.cat([slabs.parts[i].to(device) for i in slabs.owned()],
                     dim=1)


def _take_rows(slabs: RowSlabs, i: int, lo: int, hi: int) -> torch.Tensor:
    """Rows ``lo:hi`` of the split tensor on slab ``i``'s device: its
    own rows and the halo rows of the slabs that hold them (copied
    there and counted)."""
    dev, pieces = slabs.devices[i], []
    for j in slabs.owned():
        a, b = slabs.bounds[j], slabs.bounds[j + 1]
        s, e = max(lo, a), min(hi, b)
        if e <= s:
            continue
        piece = slabs.parts[j][:, s - a:e - a]
        if j != i:
            slabs.halo["rows"] += e - s
            slabs.halo["bytes"] += piece.numel() * piece.element_size()
            piece = piece.to(dev)
        pieces.append(piece)
    return torch.cat(pieces, 1) if len(pieces) > 1 else pieces[0].contiguous()


def halo_apply(fn: Callable, slabs: RowSlabs, halo: int,
               scale: str = "same", extras: Sequence[RowSlabs] = ()
               ) -> RowSlabs:
    """One stage over row slabs: for every non-empty slab, its rows
    widened by ``halo`` rows on each side (fewer at the plane's edges,
    where the stage's own zero padding applies as on one device), and
    the same rows of each of ``extras`` (slabs of the same bounds),
    through ``fn(device, x, *extras)``; the output keeps the rows the
    slab owns. ``scale``: the stage's output rows per input row, "same",
    "down" (stride 2: ``halo`` and every slab start must be even, so the
    widened slab samples the one-device rows) or "up" (a 2x upsample).
    ``halo`` must cover the stage's receptive radius at its input."""
    if halo % 2:
        raise ValueError(f"halo {halo}: row halos are even")
    h, parts = slabs.height, []
    for i, (a, b) in enumerate(zip(slabs.bounds, slabs.bounds[1:])):
        if slabs.parts[i] is None:
            parts.append(None)
            continue
        lo, hi = max(0, a - halo), min(h, b + halo)
        xs = [_take_rows(s, i, lo, hi) for s in (slabs, *extras)]
        y = fn(slabs.devices[i], *xs)
        if scale == "down":
            if a % 2:
                raise ValueError(f"slab start {a}: a stride-2 stage needs "
                                 "even starts")
            o0, o1 = (a - lo) // 2, (b - lo) // 2
        elif scale == "up":
            o0, o1 = 2 * (a - lo), 2 * (b - lo)
        else:
            o0, o1 = a - lo, b - lo
        parts.append(y[:, o0:o1])
    factor = {"same": (1, 1), "down": (1, 2), "up": (2, 1)}[scale]
    bounds = [v * factor[0] // factor[1] for v in slabs.bounds]
    return RowSlabs(parts, bounds, slabs.devices, slabs.halo)


def spatial_split(x: torch.Tensor, devices: Sequence, data: int = 1,
                  divisor: int = SPATIAL_DIVISOR) -> List[RowSlabs]:
    """JAX's ``spatial_sharding`` (batch over data, rows over model):
    ``devices`` as a (data, len / data) grid in order, the batch of
    ``x`` split contiguously over its rows of devices and each piece's
    rows over that row's devices. One RowSlabs per data index."""
    devices = list(devices)
    if len(devices) % data or x.shape[0] % data:
        raise ValueError(f"{len(devices)} devices, batch {x.shape[0]}: "
                         f"not divisible by data {data}")
    per = len(devices) // data
    return [row_split(xb, devices[d * per:(d + 1) * per], divisor)
            for d, xb in enumerate(x.chunk(data))]


def spatial_gather(groups: Sequence[RowSlabs], device) -> torch.Tensor:
    """``spatial_split``'s inverse on ``device``."""
    return torch.cat([row_gather(g, device) for g in groups], dim=0)
