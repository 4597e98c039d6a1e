"""Training and evaluation across processes: the supervised step
(``train``), its optimizer (``optim``), the device-resident trainer
(``resident``), the batched and sharded evaluation (``eval``), the process
group (``distributed``) and the data-parallel mesh over it (``mesh``)."""
from . import distributed, eval, mesh, optim, resident, train
from .mesh import make_mesh, shard_batch, shard_variables
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
    "distributed",
    "eval",
    "mesh",
    "make_mesh",
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
