"""The (data, model) mesh of a run (counterpart of
ubresnet_tpu/core/mesh.py).

The reference's only parallelism is single-process ``nn.DataParallel``
(train_ubresnet2018_wlarcv2.py:64-65,98-103) plus SLURM job arrays.
The JAX package lays a (data, model) ``jax.sharding.Mesh`` over
devices; the port, one process per card, lays the same grid over the
ranks of its process group, in JAX's order: rank d·M + m sits at
(d, m). The data axis shards the batch, and gradients, BatchNorm
moments and metrics are summed over it; the model axis shards the
widest conv weights by output channel (parallel/sharding.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ubresnet_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass
class Mesh:
    """``size``: ranks in the world; ``rank``: this process's; ``group``:
    the world's process group (None in a single-process run).
    ``model_size`` ranks share one data index: ``data_group`` holds the
    ranks of this process's model index (the ones the data axis reduces
    over), ``model_group`` those of its data index; each is None where
    it would hold this rank alone or there is no process group."""

    size: int = 1
    rank: int = 0
    group: Optional[Any] = None
    model_size: int = 1
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    def __post_init__(self):
        if self.model_size == 1 and self.data_group is None:
            self.data_group = self.group

    @property
    def data_size(self) -> int:
        return self.size // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size


def make_mesh(world: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """The (world / model_axis, model_axis) mesh over the ``world`` ranks
    of the current process group (default its size; 1 without a group).
    Every rank creates every data and model group, in the same order, as
    torch.distributed.new_group requires. Raises ValueError when the
    world does not divide by ``model_axis``."""
    n = world or distributed.process_count()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"{n} ranks not divisible by model_axis="
                         f"{model_axis}")
    rank = distributed.process_index()
    if not distributed.is_initialized():
        return Mesh(n, rank, None, model_axis)
    import torch.distributed as dist

    world_group = dist.group.WORLD
    if model_axis == 1:
        return Mesh(n, rank, world_group)
    m_size, d_size = model_axis, n // model_axis
    data_groups = [dist.new_group([d * m_size + m for d in range(d_size)])
                   for m in range(m_size)]
    model_groups = [dist.new_group([d * m_size + m for m in range(m_size)])
                    for d in range(d_size)]
    return Mesh(n, rank, world_group, m_size,
                data_groups[rank % m_size] if d_size > 1 else None,
                model_groups[rank // m_size])
