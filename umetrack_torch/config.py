"""One typed configuration tree for the port, round-tripping to JSON.

Counterpart of ``umetrack_tpu/config.py``: the same dataclasses, fields and
defaults, so a run is reproducible from one file.  A config JSON written by
the JAX package loads here: its tracker's TPU tiling knobs are dropped (and
logged), its sampler names are mapped to the port's, and any other key the
port does not know raises.
"""
from __future__ import annotations

import dataclasses
import json
import logging
from typing import Optional, Tuple

from .models.config import ModelConfig
from .tracker.types import SAMPLERS, TrackerConfig

logger = logging.getLogger(__name__)

# TrackerConfig fields of the JAX package that tune its TPU kernels' tiling
# and mean nothing to the CUDA kernels.
TPU_TRACKER_KNOBS = ("pallas_int8", "pool_sublanes", "pool_win_x")
# The JAX package's sampler names -> the port's.
JAX_SAMPLERS = {
    "pallas_pool": "kernel",
    "pallas": "kernel_full",
    "pallas_win": "kernel_win",
    "pallas_win2": "kernel_win",
    "pallas_win_cm": "kernel_win",
    "gather1d": "plain",
}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_roots: Tuple[str, ...] = ()
    fields: Tuple[str, ...] = ("mono", "labels")
    batch_size: int = 16
    crop_size: Tuple[int, int] = (96, 96)
    num_io_threads: int = 6
    max_prefetch: int = 16
    shuffle_seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """``rank`` / ``world_size``: this process's shard of the host-local
    work (``parallel/distributed.py``); ``model_axis``: the size of the
    tensor-parallel axis of the train app's mesh (``parallel/mesh.py``),
    1 for pure data parallelism, 0 for auto (2 on an even number of
    processes, else 1)."""

    model_axis: int = 1
    rank: int = 0
    world_size: int = 1

    def __post_init__(self):
        if self.model_axis < 0:
            raise ValueError(f"model_axis {self.model_axis}: use 0 (auto), 1 or more")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    # "constant" or "cosine" (linear warmup over warmup_steps, then cosine
    # decay to 1% of the peak across num_steps)
    lr_schedule: str = "constant"
    warmup_steps: int = 100
    weight_decay: float = 1e-5
    batch_size: int = 32
    num_steps: int = 1000
    log_every: int = 50
    checkpoint_every: int = 500
    checkpoint_dir: Optional[str] = None
    loss_angles: float = 1.0
    loss_wrist_points: float = 1.0
    loss_landmark_nll: float = 0.1
    loss_scale: float = 0.1
    # TBPTT window length (frames); 1 = single-frame training, >1 trains the
    # conv-RNN memory through time.
    tbptt_window: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    return obj


def _from_dict(cls, d):
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in names:
            raise KeyError(f"unknown config key {cls.__name__}.{k}")
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kwargs[k] = v
    return cls(**kwargs)


def _tracker_from_dict(d):
    d = dict(d)
    dropped = {k: d.pop(k) for k in TPU_TRACKER_KNOBS if k in d}
    if dropped:
        logger.info("dropped the JAX package's TPU tiling knobs %s", dropped)
    sampler = d.get("sampler")
    if sampler in JAX_SAMPLERS:
        d["sampler"] = JAX_SAMPLERS[sampler]
    elif sampler is not None and sampler not in SAMPLERS:
        raise ValueError(
            f"tracker sampler {sampler!r}: the port knows {SAMPLERS} and maps the JAX "
            f"package's {tuple(JAX_SAMPLERS)}"
        )
    return _from_dict(TrackerConfig, d)


def to_json(config: Config, path: Optional[str] = None) -> str:
    s = json.dumps(_to_jsonable(config), indent=2)
    if path:
        with open(path, "w") as fp:
            fp.write(s)
    return s


def from_json(source: str) -> Config:
    """Parse from a JSON string or a path to a JSON file."""
    if source.lstrip().startswith("{"):
        d = json.loads(source)
    else:
        with open(source) as fp:
            d = json.load(fp)
    unknown = set(d) - {f.name for f in dataclasses.fields(Config)}
    if unknown:
        raise KeyError(f"unknown config sections {sorted(unknown)}")
    return Config(
        model=_from_dict(ModelConfig, d.get("model", {})),
        tracker=_tracker_from_dict(d.get("tracker", {})),
        data=_from_dict(DataConfig, d.get("data", {})),
        mesh=_from_dict(MeshConfig, d.get("mesh", {})),
        train=_from_dict(TrainConfig, d.get("train", {})),
    )
