"""The training optimizer: the port's counterpart of the optax chain
``clip_by_global_norm(max_norm)`` then ``adamw(lr, weight_decay)`` and of
``optax.warmup_cosine_decay_schedule`` (``umetrack_tpu/apps/train.py``,
``parallel/resident.py``).

The Adam update itself is ``torch.optim.AdamW``'s (eps 1e-8, the same
update as optax's in exact arithmetic); what is written out here is what
differs from PyTorch's defaults:

- the clip is optax's: the gradients are scaled by ``max / ||g||`` only when
  the global norm ``||g||`` reaches ``max`` (``clip_grad_norm_`` adds 1e-6 to
  the norm and scales always);
- weight decay applies to every parameter, BatchNorm scales and biases
  included, and is scaled by the scheduled learning rate (as in optax,
  whose ``adamw`` has no mask here);
- the schedule is evaluated at the count of updates made so far, so the
  first update of a warmup has learning rate 0;
- under a ``torch.distributed`` process group the gradients are summed over
  the ranks (``all_reduce`` SUM) before the clip: each rank's loss is its
  share of the global loss (``parallel/train.py`` divides by global
  counts), so the sum is the gradient of the global loss and the clip sees
  its global norm, as the JAX step does over its mesh;
- on a mesh with a ``model`` axis (``mesh=``, after
  ``parallel/mesh.py::shard_variables``) a sharded leaf (``partition_dim``
  set) is summed over its data group only, and a replicated leaf over the
  whole group with every model index but 0 adding zeros, so the replicas
  leave the sum equal bit for bit however each rank's device rounded its
  own copy.  The clip's norm is the whole model's: the replicated leaves'
  squares once, plus the sharded leaves' squares summed over the model
  group, which is what ``optax.clip_by_global_norm`` computes on sharded
  arrays.  Adam's moments and the weight decay work on the slices as they
  are.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .distributed import is_initialized

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """optax's: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine from ``peak_value`` to ``end_value`` over
    the remaining ``decay_steps - warmup_steps``, constant after."""
    if not decay_steps - warmup_steps > 0:
        raise ValueError(
            f"the cosine decay needs positive decay_steps - warmup_steps, got "
            f"{decay_steps} - {warmup_steps}"
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


@torch.no_grad()
def all_reduce_sum_(grads: List[torch.Tensor], group=None) -> None:
    """Sum ``grads`` over ``group`` (default the whole process group) in
    place, in one collective."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _square_sum(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads)))) ** 2


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Sequence[torch.Tensor] = (), model_group=None) -> torch.Tensor:
    """Scale ``grads`` and ``sharded`` in place by ``max_norm / ||g||``
    where the global L2 norm ``||g||`` is at least ``max_norm``; returns the
    norm.  ``sharded`` are this rank's slices of leaves split over
    ``model_group``, whose squares are summed over it.  No host
    synchronisation."""
    if sharded:
        part = _square_sum(sharded)
        dist.all_reduce(part, group=model_group)
        norm = torch.sqrt(_square_sum(grads) + part)
        grads = list(grads) + list(sharded)
    else:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class ClippedAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(learning_rate,
    weight_decay))``; ``max_grad_norm=None`` leaves the clip out (plain
    ``optax.adamw``).  ``learning_rate`` is a float or a schedule of the
    update count; ``count`` is the number of updates made; ``mesh`` is the
    mesh the parameters were placed on (needed once a leaf is sharded);
    ``global_norm`` is the last step's gradient norm (before the clip)."""

    def __init__(
        self, params: Iterable[torch.nn.Parameter],
        learning_rate: Union[float, Schedule], weight_decay: float,
        max_grad_norm: Optional[float] = 1.0, mesh=None,
    ):
        self.schedule: Schedule = (
            learning_rate if callable(learning_rate) else (lambda count: learning_rate)
        )
        self.max_grad_norm = max_grad_norm
        self.mesh = mesh
        self.count = 0
        self.global_norm: Optional[torch.Tensor] = None
        super().__init__(
            params, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("ClippedAdamW takes no closure")
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        sharded = [p.grad for p in params if getattr(p, "partition_dim", None) is not None]
        grads = [p.grad for p in params if getattr(p, "partition_dim", None) is None]
        mesh = self.mesh
        if sharded and (mesh is None or mesh.model == 1):
            raise ValueError("sharded parameters: pass the mesh they were placed on (mesh=)")
        if sharded:
            if mesh.model_index:
                torch._foreach_zero_(grads)
            all_reduce_sum_(grads)
            if mesh.data > 1:
                all_reduce_sum_(sharded, mesh.data_group)
        elif is_initialized():
            all_reduce_sum_(grads, None if mesh is None else mesh.data_group)
        if self.max_grad_norm is not None:
            self.global_norm = clip_by_global_norm_(
                grads, self.max_grad_norm, sharded, None if mesh is None else mesh.model_group)
        lr = float(self.schedule(self.count))
        for group in self.param_groups:
            group["lr"] = lr
        super().step()
        self.count += 1
