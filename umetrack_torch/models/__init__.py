from .config import ModelConfig
from .convert import from_flax_variables
from .umetrack import (
    FrameInputs,
    SkeletonInputs,
    TemporalState,
    UmeTrackNet,
    init_model,
    init_weights,
    make_model,
    memory_motion_transform,
)

__all__ = [
    "ModelConfig",
    "from_flax_variables",
    "FrameInputs",
    "SkeletonInputs",
    "TemporalState",
    "UmeTrackNet",
    "init_model",
    "init_weights",
    "make_model",
    "memory_motion_transform",
]
