"""Shared CLI plumbing for the port's apps: every entry point takes the
same runtime flags.

Counterpart of ``umetrack_tpu/apps/common.py``.  A multi-process run
either joins a ``torch.distributed`` process group (``--coordinator
host:port --num-processes N --process-id i``, the JAX package's
``jax.distributed`` flags) and shards by its rank, or shards by
``--rank`` / ``--world-size`` alone.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence, Tuple

from .._device import resolve_device
from ..models import ModelConfig, UmeTrackNet, make_model
from ..ops.resample import SAMPLERS


def add_runtime_flags(
    parser: argparse.ArgumentParser, samplers: Sequence[str] = SAMPLERS
) -> None:
    """``samplers`` are the names ``--sampler`` takes: the single-image
    samplers for the torch_data app (the default), the tracker's for the
    eval apps (``tracker.types.SAMPLERS``)."""
    parser.add_argument(
        "--dtype", choices=["auto", "float32"], default="auto",
        help="model compute dtype; only float32 is ported, and 'auto' takes it",
    )
    parser.add_argument(
        "--sampler", choices=list(samplers), default=None,
        help="bilinear warp implementation; default a CUDA kernel on the GPU "
        "and plain on the CPU (a kernel needs the GPU)",
    )
    parser.add_argument(
        "--device", default=None,
        help="'cuda[:i]' (the default; raises without a GPU) or 'cpu'",
    )
    add_distributed_flags(parser)
    parser.add_argument("--rank", type=int, default=0)
    parser.add_argument("--world-size", type=int, default=1)


def add_distributed_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--coordinator", default=None,
        help="host:port of the torch.distributed store (served by process 0); when "
        "set the app joins the process group and shards by its rank, overriding "
        "--rank/--world-size",
    )
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)


def join_process_group(args) -> Optional[Tuple[int, int]]:
    """Join the process group that ``--coordinator`` / ``--num-processes``
    describe: (rank, world size), or None when they describe none."""
    from ..parallel import distributed

    if not (args.coordinator or (args.num_processes and args.num_processes > 1)):
        return None
    return distributed.initialize(
        args.coordinator, args.num_processes, args.process_id,
        device=getattr(args, "device", None),
    )


def setup_runtime(args) -> Tuple[int, int]:
    """(rank, world_size) for sequence sharding: the process group's when
    the flags describe one, else ``--rank`` / ``--world-size``."""
    joined = join_process_group(args)
    if joined:
        return joined
    if not 0 <= args.rank < args.world_size:
        raise ValueError(f"rank {args.rank} outside world size {args.world_size}")
    return args.rank, args.world_size


def tracker_config_from_args(args, **overrides):
    """TrackerConfig with the CLI's sampler selection applied."""
    from ..tracker import TrackerConfig

    if getattr(args, "sampler", None):
        overrides.setdefault("sampler", args.sampler)
    return TrackerConfig(**overrides)


def load_model_cli(
    checkpoint: Optional[str], dtype: str = "auto", device=None, seed: int = 0
) -> UmeTrackNet:
    """The model at the full width of ``ModelConfig()`` on ``device``, in
    eval mode, with the weights of ``checkpoint`` (a flax ``.msgpack`` file
    or a ``.torch`` state dict of the original model) or, without one,
    seeded random weights."""
    if dtype not in ("auto", "float32"):
        raise ValueError(f"dtype {dtype!r}: only float32 is ported")
    device = resolve_device(device)
    config = ModelConfig()
    if not checkpoint:
        return make_model(config, seed=seed, device=device)
    from ..utils.checkpoints import load_checkpoint

    model = UmeTrackNet(config)
    model.load_state_dict(load_checkpoint(checkpoint, config))
    return model.to(device).eval()
