"""Multi-process initialisation and launch helpers (counterpart of
ubresnet_tpu/parallel/distributed.py).

The reference's cluster story is SLURM arrays of independent trainings
(grid_scripts/sbatch_submit_larcv1_training.sh:11-22). The port
supports both modes, one process per card:

  * job-level parallelism: ``cli/launch.py --sweep`` runs independent
    configs as processes;
  * one training across processes: ``initialize()`` joins a
    ``torch.distributed`` process group, and the train step reduces
    gradients, BatchNorm moments and metrics over it
    (parallel/sharding.py).

The env contract is the JAX package's: UBTPU_COORDINATOR (host:port),
UBTPU_NUM_PROCESSES, UBTPU_PROCESS_ID, which ``cli/launch.py
--distributed N`` exports. Without a coordinator ``initialize()`` is a
no-op; with one it joins a world even of one process, so that
``--distributed 1`` runs the collectives (each the identity).

Backend: NCCL when every rank on a host has a card of its own (the
ranks that share this host fit its visible devices), gloo on the CPU
and when ranks share a card — NCCL refuses two ranks on one GPU. The
ranks learn which of them share a host by posting their host names to
the rendezvous store; ``backend()`` says which was taken.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ubresnet_tpu_torch.utils import platform
from ubresnet_tpu_torch.utils.platform import resolve_device

COORDINATOR_ENV = "UBTPU_COORDINATOR"
NUM_PROCESSES_ENV = "UBTPU_NUM_PROCESSES"
PROCESS_ID_ENV = "UBTPU_PROCESS_ID"

# a CPU-side (gloo) group for barriers with a timeout, beside an NCCL
# default group (monitored_barrier is gloo's)
_barrier_group = None


def host_layout(hosts: List[str], rank: int) -> Tuple[int, int]:
    """(local rank, ranks on this host) of ``rank`` given every rank's
    host name in rank order."""
    mine = hosts[rank]
    return (sum(h == mine for h in hosts[:rank]),
            sum(h == mine for h in hosts))


def choose_backend(local_world: int, device: torch.device) -> str:
    """"nccl" when ``device`` is a card and each of the ``local_world``
    ranks on this host can have its own, else "gloo"."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout_s: float = 1800.0) -> bool:
    """Join the process group of a distributed run: a TCP rendezvous
    store at ``coordinator`` (host:port, hosted by rank 0, as
    ``init_method=f"tcp://{coordinator}"`` would), on which the ranks
    post their host names, then init_process_group over it with this
    rank, the world size and the backend from ``choose_backend`` for
    the ranks on this host. Arguments fall back to UBTPU_COORDINATOR /
    UBTPU_NUM_PROCESSES / UBTPU_PROCESS_ID; without a coordinator (a
    single-process run) nothing happens and False is returned.
    ``device``: where this rank computes (``resolve_device``: a bare
    "cuda" is ``cuda:{local rank % device_count}``, set as the current
    device)."""
    global _barrier_group
    coordinator_address = (coordinator_address
                           or os.environ.get(COORDINATOR_ENV))
    if num_processes is None:
        num_processes = int(os.environ.get(NUM_PROCESSES_ENV, "1"))
    if process_id is None:
        process_id = int(os.environ.get(PROCESS_ID_ENV, "0"))
    if not coordinator_address:
        return False
    if dist.is_initialized():
        return True
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    store.set(f"ubtpu_host/{process_id}", socket.gethostname())
    hosts = [store.get(f"ubtpu_host/{r}").decode()
             for r in range(num_processes)]
    local_rank, local_world = host_layout(hosts, process_id)
    platform.set_local_rank(local_rank)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(local_world, dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _barrier_group = (dist.new_group(backend="gloo") if backend != "gloo"
                      else dist.group.WORLD)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def backend() -> Optional[str]:
    """The default group's backend, or None in a single-process run."""
    return dist.get_backend() if is_initialized() else None


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def barrier(name: str, timeout_s: float = 600.0) -> bool:
    """Rendezvous every process, raising if one has not arrived within
    ``timeout_s`` (gloo's monitored_barrier on a CPU-side group, so it
    can span a peer's cold kernel build whatever the backend). ``name``
    says what is awaited in the error. No-op (False) in a
    single-process run."""
    if not is_initialized():
        return False
    try:
        dist.monitored_barrier(
            group=_barrier_group,
            timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f"barrier '{name}': {e}") from e
    return True


def shutdown() -> None:
    """Leave the process group (no-op when there is none)."""
    global _barrier_group
    if is_initialized():
        dist.destroy_process_group()
    _barrier_group = None
    platform.set_local_rank(None)
