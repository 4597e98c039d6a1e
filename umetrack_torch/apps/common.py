"""Shared CLI plumbing for the port's apps: every entry point takes the
same runtime flags.

Counterpart of ``umetrack_tpu/apps/common.py``.  Multi-process runs are
sharded by ``--rank`` / ``--world-size`` alone; the JAX package's
``jax.distributed`` flags have no counterpart yet.
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

from .._device import resolve_device
from ..models import ModelConfig, UmeTrackNet, make_model
from ..ops.resample import SAMPLERS


def add_runtime_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--dtype", choices=["auto", "float32"], default="auto",
        help="model compute dtype; only float32 is ported, and 'auto' takes it",
    )
    parser.add_argument(
        "--sampler", choices=SAMPLERS, default=None,
        help="bilinear warp implementation; default kernel_win on the GPU "
        "and plain on the CPU (a kernel needs the GPU)",
    )
    parser.add_argument(
        "--device", default=None,
        help="'cuda[:i]' (the default; raises without a GPU) or 'cpu'",
    )
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world-size", type=int, default=1)


def setup_runtime(args) -> Tuple[int, int]:
    """(rank, world_size) for sequence sharding."""
    if not 0 <= args.rank < args.world_size:
        raise ValueError(f"rank {args.rank} outside world size {args.world_size}")
    return args.rank, args.world_size


def load_model_cli(
    checkpoint: Optional[str], dtype: str = "auto", device=None, seed: int = 0
) -> UmeTrackNet:
    """The model at the full width of ``ModelConfig()`` on ``device`` with
    seeded random weights.  A checkpoint raises: the loader (flax msgpack ->
    state dict) is ROADMAP Queue 1 item 7 and is not ported yet."""
    if checkpoint:
        raise NotImplementedError(
            "--checkpoint: the checkpoint loader is not ported yet "
            "(ROADMAP Queue 1 item 7); run without it for seeded random weights"
        )
    if dtype not in ("auto", "float32"):
        raise ValueError(f"dtype {dtype!r}: only float32 is ported")
    return make_model(ModelConfig(), seed=seed, device=resolve_device(device))
