"""The (``data``, ``model``) mesh of the port's processes, and the
placement of the weights and the batches on it.

Counterpart of ``umetrack_tpu/parallel/mesh.py``.  The JAX package lays its
devices out on a (data, model) mesh and lets XLA insert the collectives; the
port runs one process per rank of a ``torch.distributed`` group and writes
its collectives (``parallel/collectives.py``).  The layout is JAX's
``reshape(n // model, model)``: rank ``r`` sits at data index ``r // model``
and model index ``r % model``, so a model group is a run of consecutive
ranks and a data group takes every ``model``-th rank.

- ``data``: a batch splits into contiguous blocks of its leading axis, one
  per data index; the ranks of one model group hold the same block.
- ``model`` (tensor parallelism): a Conv or Dense weight that passes
  :func:`param_sharding`'s rule is split along its output channels, one
  contiguous slice per model index; every other leaf (BatchNorm scales,
  biases, running stats, small or odd-width kernels) is replicated.  The
  JAX package defines the axis as a layout: sharded results equal the
  unsharded ones up to rounding.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .._tree import TensorTree
from ..models.backbone import BatchNorm, Conv, Dense
from .collectives import gather_blocks
from .distributed import is_initialized, rank_and_world

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``data`` x ``model`` ranks, this process's ``rank``, and the process
    groups of its model run and of its data stride.  Both are None when
    ``model`` is 1: the data axis is then the whole process group (the
    default group of every collective), and there is no model group."""

    data: int
    rank: int
    model: int = 1
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def mesh_shape(world: int, model_axis: int = 1) -> Tuple[int, int]:
    """(data, model) for ``world`` ranks; ``model_axis=0`` is auto: 2 on an
    even world of at least 2, else 1.  Raises unless ``model_axis`` divides
    the world."""
    if model_axis == 0:
        model_axis = 2 if world % 2 == 0 and world >= 2 else 1
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide {world} ranks")
    return world // model_axis, model_axis


def make_mesh(world: Optional[int] = None, model_axis: int = 1) -> Mesh:
    """The mesh of ``world`` ranks (default the process group's size, 1
    without a group) shaped (data, model) by :func:`mesh_shape`.  With
    ``model > 1`` it makes a process group for every model run and every
    data stride: every rank must call it, with the same arguments."""
    rank, group_world = rank_and_world()
    world = group_world if world is None else world
    if world != group_world:
        raise ValueError(f"a mesh of {world} ranks in a process group of {group_world}")
    data, model = mesh_shape(world, model_axis)
    data_group = model_group = None
    if model > 1:
        layout = np.arange(world).reshape(data, model)
        # every rank makes every group, in the same order
        for ranks in layout:
            group = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                model_group = group
        for ranks in layout.T:
            group = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                data_group = group
    return Mesh(data=data, rank=rank, model=model, data_group=data_group, model_group=model_group)


def block(n: int, mesh: Mesh) -> slice:
    """The contiguous block of ``n`` leading rows that ``mesh.data_index``
    holds."""
    if n % mesh.data:
        raise ValueError(f"{n} rows do not split over {mesh.data} ranks")
    rows = n // mesh.data
    return slice(mesh.data_index * rows, (mesh.data_index + 1) * rows)


def param_sharding(mesh: Mesh, min_shard_size: int = 1024) -> Callable[[str, torch.Tensor], Spec]:
    """The spec of each leaf of a state dict, by name: a Conv or Dense
    ``weight`` whose output-channel dim (torch's dim 0, the JAX kernel's
    last axis) divides the model axis and which holds at least
    ``min_shard_size`` elements is split over ``model`` on dim 0; every
    other leaf is replicated (``()``).  BatchNorm's ``weight`` is 1-D, so
    the rank test leaves it out, as the JAX rule leaves ``scale`` out."""

    def leaf_sharding(name: str, leaf: torch.Tensor) -> Spec:
        if (
            mesh.model > 1
            and name.endswith("weight")
            and leaf.dim() >= 2
            and leaf.shape[0] % mesh.model == 0
            and leaf.numel() >= min_shard_size
        ):
            return ("model",) + (None,) * (leaf.dim() - 1)
        return ()

    return leaf_sharding


def batch_sharding(mesh: Mesh) -> Callable[[torch.Tensor], Spec]:
    """The spec of a batched leaf: its leading axis over ``data``."""

    def fn(leaf: torch.Tensor) -> Spec:
        return ("data",) + (None,) * (leaf.dim() - 1) if leaf.dim() >= 1 else ()

    return fn


def replicated(mesh: Mesh) -> Spec:
    """The spec of a leaf every rank holds whole."""
    return ()


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous block of the leading axis of every leaf of
    ``batch`` (a tensor or a tensor dataclass), by data index."""
    if isinstance(batch, TensorTree):
        return batch.map(lambda a: a[block(a.shape[0], mesh)])
    return batch[block(batch.shape[0], mesh)]


def _tp_modules(model: torch.nn.Module):
    return [(name, m) for name, m in model.named_modules() if isinstance(m, (Conv, Dense))]


@torch.no_grad()
def shard_variables(model: torch.nn.Module, mesh: Mesh, min_shard_size: int = 1024) -> torch.nn.Module:
    """Place the weights on ``mesh``: every rank takes rank 0's parameters
    and buffers (BatchNorm running stats included); then, with ``model >
    1``, each weight that :func:`param_sharding` splits is replaced by this
    rank's contiguous slice of its dim 0 (a new ``Parameter``: build the
    optimizer after this call) and its ``Conv`` / ``Dense`` computes through
    the model group, and every ``Conv`` keeps the group as ``mesh_group``
    (the model then stays NCHW on a card).  Every ``BatchNorm`` normalises
    over the data group, and the model keeps the mesh (``model.mesh``) for
    the reductions of the train step and the evaluation.  Returns
    ``model``."""
    if mesh.data * mesh.model > 1 or is_initialized():
        for tensor in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(tensor.data, src=0)
    if mesh.model > 1:
        rule = param_sharding(mesh, min_shard_size)
        for name, module in _tp_modules(model):
            if isinstance(module, Conv):
                module.mesh_group = mesh.model_group  # a sharded model's layers all stay NCHW
            if rule(f"{name}.weight", module.weight):
                width = module.weight.shape[0] // mesh.model
                part = module.weight.narrow(0, mesh.model_index * width, width).clone()
                module.weight = torch.nn.Parameter(part)
                module.weight.partition_dim = 0
                module.model_group = mesh.model_group
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.data_group = mesh.data_group
    model.mesh = mesh
    return model


@torch.no_grad()
def full_state_dict(model: torch.nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The whole model's state dict on every rank: each sharded weight
    gathered over the model group, the replicated leaves as they are.  A
    collective: every rank must call it (a save that calls it on rank 0
    alone deadlocks)."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    if mesh.model > 1:
        for name, module in _tp_modules(model):
            if module.model_group is not None:
                state[f"{name}.weight"] = gather_blocks(module.weight.detach(), 0, module.model_group)
    return state


def data_group_of(model: torch.nn.Module):
    """The data group of the mesh ``model`` was placed on (None: the whole
    process group, also for a model never placed)."""
    mesh = getattr(model, "mesh", None)
    return None if mesh is None else mesh.data_group
