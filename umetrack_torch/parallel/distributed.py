"""Multi-process initialisation and work sharding over ``torch.distributed``.

Counterpart of ``umetrack_tpu/parallel/distributed.py``: the JAX package
joins its hosts with ``jax.distributed.initialize``; the port joins its
processes in one ``torch.distributed`` process group (NCCL between cards,
gloo on the CPU).  Host-local work (video decode, file IO) shards by rank;
the device work reduces with the group's collectives (``parallel/eval.py``,
``parallel/train.py``, ``models/backbone.py::BatchNorm``).
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .._device import resolve_device

logger = logging.getLogger(__name__)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> Tuple[int, int]:
    """Join the process group at ``tcp://{coordinator_address}`` (host:port,
    the store served by process 0) as ``process_id`` of ``num_processes``;
    a no-op for one process with no coordinator, as in the JAX package.
    ``backend`` defaults to ``nccl`` when ``device`` is CUDA (the default;
    each process takes card ``process_id % device_count``) and ``gloo``
    when it is the CPU.  Returns (rank, world size)."""
    if is_initialized():
        raise RuntimeError("the process group is already initialised")
    if coordinator_address is None and not (num_processes and num_processes > 1):
        return rank_and_world()
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator address (host:port)")
    world = 1 if num_processes is None else num_processes
    rank = 0 if process_id is None else process_id
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside {world} processes")
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank
    )
    logger.info("process %d/%d joined %s over %s", rank, world, coordinator_address, backend)
    return rank, world


def finalize() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        dist.destroy_process_group()


def shard_list_for_host(items: Sequence) -> list:
    """Round-robin shard of host-local work items (e.g. recording paths)
    for this process: ``items[rank::world]``."""
    rank, world = rank_and_world()
    return list(items[rank::world])
