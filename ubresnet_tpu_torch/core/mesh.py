"""The data axis of a run (counterpart of ubresnet_tpu/core/mesh.py).

The reference's only parallelism is single-process ``nn.DataParallel``
(train_ubresnet2018_wlarcv2.py:64-65,98-103) plus SLURM job arrays.
The JAX package lays a (data, model) ``jax.sharding.Mesh`` over
devices; the port, one process per card, has the data axis only, laid
over the ranks of its process group: it shards the batch, and
gradients, BatchNorm moments and metrics are summed over it
(parallel/sharding.py). A model axis (channel sharding) waits in
ROADMAP queue 1, item 10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ubresnet_tpu_torch.parallel import distributed

DATA_AXIS = "data"


@dataclasses.dataclass
class Mesh:
    """``size``: ranks on the data axis; ``rank``: this process's index
    on it; ``group``: the process group the data axis reduces over (the
    whole world), None in a single-process run."""

    size: int = 1
    rank: int = 0
    group: Optional[Any] = None


def make_mesh(world: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """The data axis over the ``world`` ranks of the current process
    group (default its size; 1 without a group), whose group (the
    default one) the step reduces over. ``model_axis`` > 1 raises."""
    if model_axis > 1:
        raise NotImplementedError(
            "model_axis > 1 (channel sharding, parallel/sharding.py "
            "make_param_shardings) is not in the port yet: ROADMAP "
            "queue 1, item 10")
    group = None
    if distributed.is_initialized():
        import torch.distributed as dist

        group = dist.group.WORLD
    return Mesh(world or distributed.process_count(),
                distributed.process_index(), group)
