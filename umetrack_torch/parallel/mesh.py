"""The data-parallel "mesh" of the port's processes.

Counterpart of ``umetrack_tpu/parallel/mesh.py``.  The JAX package lays its
devices out on a (``data``, ``model``) mesh and lets XLA insert the
collectives; the port runs one process per card in a ``torch.distributed``
group, so its mesh is the group seen as a ``data`` axis of ``world``
ranks: a batch splits into contiguous blocks of its leading axis, one per
rank, and the weights are replicated from rank 0.  The ``model`` axis
(tensor parallelism) stays at 1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .._tree import TensorTree
from .distributed import is_initialized, rank_and_world

# Why the model axis is not ported: at ~1M parameters channel sharding
# does not pay for its collectives.
TP_NOT_PORTED = (
    "model_axis {}: tensor parallelism (and 0, 'auto') is not ported; the JAX package "
    "measured (data=4, model=2) ~2x slower than (data=8,) at this model size "
    "(umetrack_tpu/parallel/mesh.py:26-29)"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` ranks by ``model`` = 1, and this process's rank."""

    data: int
    rank: int
    model: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}


def make_mesh(world: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """The mesh of ``world`` ranks (default the process group's size, 1
    without a group) along ``data``."""
    if model_axis != 1:
        raise NotImplementedError(TP_NOT_PORTED.format(model_axis))
    rank, group_world = rank_and_world()
    world = group_world if world is None else world
    if world != group_world:
        raise ValueError(f"a mesh of {world} ranks in a process group of {group_world}")
    return Mesh(data=world, rank=rank)


def block(n: int, mesh: Mesh) -> slice:
    """The contiguous block of ``n`` leading rows that ``mesh.rank`` holds."""
    if n % mesh.data:
        raise ValueError(f"{n} rows do not split over {mesh.data} ranks")
    rows = n // mesh.data
    return slice(mesh.rank * rows, (mesh.rank + 1) * rows)


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous block of the leading axis of every leaf of
    ``batch`` (a tensor or a tensor dataclass)."""
    if isinstance(batch, TensorTree):
        return batch.map(lambda a: a[block(a.shape[0], mesh)])
    return batch[block(batch.shape[0], mesh)]


@torch.no_grad()
def shard_variables(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replicate the weights: every rank takes rank 0's parameters and
    buffers (BatchNorm running stats included).  Returns ``model``."""
    if mesh.data > 1 or is_initialized():
        for tensor in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(tensor.data, src=0)
    return model
