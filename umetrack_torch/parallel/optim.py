"""The training optimizer: the port's counterpart of the optax chain
``clip_by_global_norm(max_norm)`` then ``adamw(lr, weight_decay)`` and of
``optax.warmup_cosine_decay_schedule`` (``umetrack_tpu/apps/train.py``,
``parallel/resident.py``).

The update is written out in optax's order of operations (eps 1e-8), with
what differs from ``torch.optim.AdamW``'s defaults:

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
  are;
- the update count, the scheduled learning rate and Adam's bias
  corrections live on the device, so a captured CUDA graph of a train step
  (``tracker/compiled.py``) replays the update as it ran: no value of the
  step is read on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from .distributed import is_initialized

Schedule = Callable[[Union[int, torch.Tensor]], Union[float, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class WarmupCosineDecay:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then a cosine from
    ``peak_value`` to ``end_value`` over the remaining ``decay_steps -
    warmup_steps``, constant after.  Called with a Python int it returns a
    float (for logs and tests); with a tensor count it returns a float64
    tensor computed on the count's device, which a CUDA graph can replay."""

    init_value: float
    peak_value: float
    warmup_steps: int
    decay_steps: int
    end_value: float = 0.0

    def __post_init__(self):
        if not self.decay_steps - self.warmup_steps > 0:
            raise ValueError(
                f"the cosine decay needs positive decay_steps - warmup_steps, got "
                f"{self.decay_steps} - {self.warmup_steps}"
            )

    @property
    def alpha(self) -> float:
        return 0.0 if self.peak_value == 0.0 else self.end_value / self.peak_value

    def __call__(self, count):
        if isinstance(count, torch.Tensor):
            return self._on_device(count)
        warmup, span = self.warmup_steps, self.decay_steps - self.warmup_steps
        if count < warmup:
            frac = 1.0 - min(max(count, 0), warmup) / warmup
            return (self.init_value - self.peak_value) * frac + self.peak_value
        t = min(count - warmup, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return self.peak_value * ((1.0 - self.alpha) * cosine + self.alpha)

    def _on_device(self, count: torch.Tensor) -> torch.Tensor:
        """The same arithmetic in float64 tensor ops, both branches
        computed and one selected (no host read of the count)."""
        c = count.to(torch.float64)
        warmup, span = self.warmup_steps, self.decay_steps - self.warmup_steps
        frac = 1.0 - torch.clamp(c, 0, warmup) / max(warmup, 1)
        warm = (self.init_value - self.peak_value) * frac + self.peak_value
        t = torch.clamp(c - warmup, max=span)
        cosine = 0.5 * (1.0 + torch.cos(math.pi * t / span))
        decayed = self.peak_value * ((1.0 - self.alpha) * cosine + self.alpha)
        return torch.where(c < warmup, warm, decayed)


@dataclasses.dataclass(frozen=True)
class Constant:
    """A constant learning rate in the schedule's two forms."""

    value: float

    def __call__(self, count):
        if isinstance(count, torch.Tensor):
            return torch.full_like(count, self.value, dtype=torch.float64)
        return self.value


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> WarmupCosineDecay:
    """optax's schedule of that name (see :class:`WarmupCosineDecay`)."""
    return WarmupCosineDecay(init_value, peak_value, warmup_steps, decay_steps, end_value)


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


class ClippedAdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(learning_rate,
    weight_decay))``; ``max_grad_norm=None`` leaves the clip out (plain
    ``optax.adamw``).  ``learning_rate`` is a float or a schedule of the
    update count taking a Python int and a tensor (:class:`WarmupCosineDecay`,
    :class:`Constant`); ``mesh`` is the mesh the parameters were placed on
    (needed once a leaf is sharded).

    Capturable: the update count (``step_count``), the learning rate, Adam's
    bias corrections and the clip are device tensors and every update is a
    device op, so a CUDA graph of a whole train step replays the optimizer
    as it ran.  :meth:`prepare` makes the state (moments, count, the
    gradients) at fixed addresses before a capture; :meth:`update` is the
    device work alone, :meth:`step` adds the host's mirror ``count`` (the
    number of updates made, never read by an update).  ``global_norm`` is
    the last update's gradient norm before the clip (a device tensor)."""

    def __init__(
        self, params: Iterable[torch.nn.Parameter],
        learning_rate: Union[float, Schedule], weight_decay: float,
        max_grad_norm: Optional[float] = 1.0, mesh=None,
    ):
        self.schedule: Schedule = (
            learning_rate if callable(learning_rate) else Constant(float(learning_rate))
        )
        self.max_grad_norm = max_grad_norm
        self.mesh = mesh
        self.count = 0
        self.step_count: Optional[torch.Tensor] = None
        self.global_norm: Optional[torch.Tensor] = None
        super().__init__(params, dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay))

    def _params(self) -> List[torch.nn.Parameter]:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def prepare(self) -> None:
        """Make what an update writes, where it is missing: a zero gradient
        for each parameter, Adam's moments, the update count and the norm.
        Each later update writes into these tensors in place."""
        params = self._params()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if not self.state[p]:
                self.state[p] = dict(exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
        if self.step_count is None:
            device = params[0].device
            self.step_count = torch.full((), float(self.count), dtype=torch.float64, device=device)
            self.global_norm = torch.zeros((), device=device)

    def capture_key(self) -> tuple:
        """What a captured update bakes in: the hyperparameters, the
        schedule and the data pointers of everything it reads and writes."""
        hyper = tuple((g["betas"], g["eps"], g["weight_decay"], len(g["params"])) for g in self.param_groups)
        tensors = [self.step_count, self.global_norm]
        for p in self._params():
            tensors += [p, p.grad, *self.state[p].values()]
        return (hyper, self.schedule, self.max_grad_norm,
                tuple(None if t is None else t.data_ptr() for t in tensors))

    def snapshot(self) -> dict:
        """The state an update reads, on the CPU: the update count and each
        parameter's moments in parameter order (:meth:`restore`)."""
        self.prepare()
        return dict(count=self.count, moments=[
            (self.state[p]["exp_avg"].cpu().clone(), self.state[p]["exp_avg_sq"].cpu().clone())
            for p in self._params()
        ])

    @torch.no_grad()
    def restore(self, snapshot: dict) -> None:
        """Continue from :meth:`snapshot`'s state, written into this
        optimizer's own tensors in place."""
        params = self._params()
        if len(snapshot["moments"]) != len(params):
            raise ValueError(f"snapshot of {len(snapshot['moments'])} parameters, optimizer of {len(params)}")
        self.count = int(snapshot["count"])
        self.prepare()
        self.step_count.fill_(float(self.count))
        for p, (mu, nu) in zip(params, snapshot["moments"]):
            self.state[p]["exp_avg"].copy_(mu)
            self.state[p]["exp_avg_sq"].copy_(nu)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("ClippedAdamW takes no closure")
        self.prepare()
        self.update()
        self.count += 1

    @torch.no_grad()
    def update(self) -> None:
        """One update on the device, host state untouched: the gradients
        summed over the ranks under a process group, the clip, then AdamW
        in optax's order of operations, at the learning rate of the count of
        updates made so far."""
        params = self._params()
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
            self.global_norm.copy_(clip_by_global_norm_(
                grads, self.max_grad_norm, sharded, None if mesh is None else mesh.model_group))

        neg_lr = -self.schedule(self.step_count).to(torch.float32)
        self.step_count.add_(1.0)
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ps = group["params"]
            gs = [p.grad for p in ps]
            mu = [self.state[p]["exp_avg"] for p in ps]
            nu = [self.state[p]["exp_avg_sq"] for p in ps]
            # optax: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(gs, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - b2))
            # bias corrections in float64, rounded once (optax casts them to the moments' dtype)
            bc1 = (1.0 - torch.pow(b1, self.step_count)).to(torch.float32)
            bc2 = (1.0 - torch.pow(b2, self.step_count)).to(torch.float32)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_mul_(upd, neg_lr)
            torch._foreach_add_(ps, upd)
