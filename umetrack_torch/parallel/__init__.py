"""Training on one device: the supervised step (``train``), its optimizer
(``optim``) and the device-resident trainer (``resident``).  The JAX
package's multi-device modules (``mesh``, ``eval``, ``distributed``) are not
ported yet."""
from . import optim, resident, train
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
