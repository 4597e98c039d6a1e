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
from ..models.config import COMPUTE_DTYPES
from ..ops.resample import SAMPLERS

DTYPES = ("auto",) + tuple(COMPUTE_DTYPES)


def add_runtime_flags(
    parser: argparse.ArgumentParser, samplers: Sequence[str] = SAMPLERS
) -> None:
    """``samplers`` are the names ``--sampler`` takes: the single-image
    samplers for the torch_data app (the default), the tracker's for the
    eval apps (``tracker.types.SAMPLERS``)."""
    parser.add_argument(
        "--dtype", choices=DTYPES, default="auto",
        help="model compute dtype (parameters stay float32); 'auto' = float32 on "
        "every device, the dtype the port's parity is held at",
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


def resolve_dtype(dtype: str, device=None) -> str:
    """The compute dtype that ``--dtype`` names: ``float32`` or ``bfloat16``
    as given, and ``auto`` -> ``float32`` on every device, CUDA included.
    The JAX package maps ``auto`` to bfloat16 on its accelerator; the port
    keeps float32, the dtype at which it is held to the JAX package and the
    card to the CPU, and runs bfloat16 when asked (``--dtype bfloat16``).
    The answer is the same for every ``device``, the CPU and CUDA alike.
    Any other name raises."""
    if dtype == "auto":
        return "float32"
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"dtype {dtype!r}: use one of {DTYPES}")
    return dtype


def tracker_config_from_args(args, **overrides):
    """TrackerConfig with the CLI's sampler selection applied."""
    from ..tracker import TrackerConfig

    if getattr(args, "sampler", None):
        overrides.setdefault("sampler", args.sampler)
    return TrackerConfig(**overrides)


def load_model_cli(
    checkpoint: Optional[str], dtype: str = "auto", device=None, seed: int = 0
) -> UmeTrackNet:
    """The model at the full width of ``ModelConfig()`` in the compute dtype
    ``dtype`` resolves to (:func:`resolve_dtype`; parameters stay f32) on
    ``device``, in eval mode, with the weights of ``checkpoint`` (a flax
    ``.msgpack`` file, a ``.torch`` state dict of the original model or an
    orbax checkpoint directory) or, without one, seeded random weights."""
    device = resolve_device(device)
    config = ModelConfig(compute_dtype=resolve_dtype(dtype, device))
    if not checkpoint:
        return make_model(config, seed=seed, device=device)
    from ..utils.checkpoints import load_checkpoint

    model = UmeTrackNet(config)
    model.load_state_dict(load_checkpoint(checkpoint, config))
    return model.to(device).eval()
