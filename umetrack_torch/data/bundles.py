"""Helpers over host-side data bundles: nested dataclasses, dicts, lists
and tuples whose leaves are numpy arrays or tensors (``None`` stays
``None``).  The port's stand-in for the JAX package's ``data/bundles.py``,
which leaned on ``jax.tree_util``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch


def _map(fn: Callable, *bundles: Any) -> Any:
    """``fn`` over corresponding leaves of identically-structured bundles."""
    first = bundles[0]
    if first is None:
        return None
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _map(fn, *(getattr(b, f.name) for b in bundles))
            for f in dataclasses.fields(first)
        })
    if isinstance(first, dict):
        return {k: _map(fn, *(b[k] for b in bundles)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *items) for items in zip(*bundles))
    return fn(*bundles)


def map_fields(fn: Callable, bundle: Any, only_type: Optional[type] = None) -> Any:
    """Apply ``fn`` to every leaf (optionally only leaves of ``only_type``)."""
    if only_type is None:
        return _map(fn, bundle)
    return _map(lambda x: fn(x) if isinstance(x, only_type) else x, bundle)


def collate(samples: Sequence[Any]) -> Any:
    """Stack a list of identically-structured bundles along a new axis 0."""
    def stack(*xs):
        return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)

    return _map(stack, *samples)


def group(samples: Sequence[Any], fn: Callable) -> Any:
    """Combine corresponding leaves with ``fn`` (e.g. ``np.concatenate``)."""
    return _map(lambda *xs: fn(xs), *samples)


def to_device(bundle: Any, device) -> Any:
    """Every array leaf as a tensor on ``device``."""
    def leaf(x):
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()  # an mmap'ed frame: torch takes writable arrays only
        return torch.as_tensor(x).to(device)

    return _map(leaf, bundle)
