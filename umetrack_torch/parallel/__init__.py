"""Training and evaluation across processes: the supervised step
(``train``), its optimizer (``optim``), the device-resident trainer
(``resident``), the batched and sharded evaluation (``eval``), the process
group (``distributed``), the (data, model) mesh over it (``mesh``) and the
model axis's collectives (``collectives``)."""
from . import collectives, distributed, eval, mesh, optim, resident, train
from .mesh import (
    batch_sharding,
    full_state_dict,
    make_mesh,
    param_sharding,
    replicated,
    shard_batch,
    shard_variables,
)
from .optim import ClippedAdamW, warmup_cosine_decay_schedule
from .train import (
    LossWeights,
    TemporalTrainBatch,
    TrainBatch,
    TrainState,
    create_train_state,
    init_train_model,
    loss_fn,
    synthetic_train_batch,
    temporal_loss_fn,
    temporal_train_step,
    train_step,
)

__all__ = [
    "collectives",
    "distributed",
    "eval",
    "mesh",
    "batch_sharding",
    "full_state_dict",
    "make_mesh",
    "param_sharding",
    "replicated",
    "shard_batch",
    "shard_variables",
    "optim",
    "resident",
    "train",
    "ClippedAdamW",
    "warmup_cosine_decay_schedule",
    "LossWeights",
    "TemporalTrainBatch",
    "TrainBatch",
    "TrainState",
    "create_train_state",
    "init_train_model",
    "loss_fn",
    "synthetic_train_batch",
    "temporal_loss_fn",
    "temporal_train_step",
    "train_step",
]
