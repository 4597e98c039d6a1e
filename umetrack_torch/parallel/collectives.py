"""The collectives of the tensor-parallel ``model`` axis, written from
``all_reduce`` alone.

The JAX package annotates shardings and lets XLA place the collectives
(``umetrack_tpu/parallel/mesh.py``); the port writes them.  A layer whose
weight is split over the ``model`` group along its output channels
(``parallel/mesh.py::shard_variables``) computes

    gather_from_model(conv(copy_to_model(x), weight_slice))

- :func:`gather_from_model`: the ranks' channel slices concatenated in
  model-index order.  Downstream every rank of the group computes the same
  thing, so the backward takes this rank's slice of the incoming gradient
  and sums nothing.  (``torch.distributed.nn.functional.all_gather`` sums
  the ranks' gradients in its backward, which would multiply every gradient
  upstream of a sharded layer by the group's size.)
- :func:`copy_to_model`: the identity, whose backward sums the input
  gradient over the group: each rank's slice of output channels yields only
  a partial gradient of the layer's input.

The gather is an ``all_reduce`` (SUM) of a zero-filled full-width buffer
into which each rank writes its slice: every element is one rank's value
plus zeros, so it is exact.  ``all_reduce`` and ``broadcast`` are the
collectives gloo runs on CUDA tensors (several processes sharing one card),
and on the CPU and over NCCL the same code runs.  ``group=None`` is the
whole process group.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def gather_blocks(x: torch.Tensor, dim: int = 0, group=None) -> torch.Tensor:
    """The group's equal blocks of ``x`` concatenated along ``dim`` in the
    group's rank order (no gradient)."""
    n, index = dist.get_world_size(group), dist.get_rank(group)
    dim = dim % x.dim()
    shape = list(x.shape)
    width = shape[dim]
    shape[dim] = width * n
    full = x.new_zeros(shape)
    full.narrow(dim, index * width, width).copy_(x)
    dist.all_reduce(full, group=group)
    return full


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.width = dim % y.dim(), y.shape[dim]
        ctx.index = dist.get_rank(group)
        return gather_blocks(y, ctx.dim, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(ctx.dim, ctx.index * ctx.width, ctx.width).contiguous(), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def gather_from_model(y: torch.Tensor, dim: int = 1, group: Optional[object] = None) -> torch.Tensor:
    """The model group's slices of ``y`` along ``dim``, concatenated in
    model-index order; the backward is this rank's slice of the gradient."""
    return _GatherFromModel.apply(y, dim, group)


def copy_to_model(x: torch.Tensor, group: Optional[object] = None) -> torch.Tensor:
    """``x`` as it is; the backward sums the gradient over the model group."""
    return _CopyToModel.apply(x, group)
