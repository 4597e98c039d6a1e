"""Dataclasses of tensors: the port's stand-in for JAX pytrees."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


class TensorTree:
    """Mixin for dataclasses whose fields are tensors, None, or nested
    tensor dataclasses."""

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """A copy with ``fn`` applied to every tensor field."""

        def apply(v):
            if v is None:
                return None
            if isinstance(v, TensorTree):
                return v.map(fn)
            return fn(v)

        return dataclasses.replace(
            self, **{f.name: apply(getattr(self, f.name)) for f in dataclasses.fields(self)}
        )

    def to(self, device):
        return self.map(lambda a: a.to(device))
