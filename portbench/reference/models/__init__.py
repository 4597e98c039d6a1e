from .config import ModelConfig
from .convert import from_flax_variables
from .umetrack import (
    FrameInputs,
    SkeletonInputs,
    TemporalState,
    UmeTrackNet,
    memory_motion_transform,
)

__all__ = [
    "ModelConfig",
    "from_flax_variables",
    "FrameInputs",
    "SkeletonInputs",
    "TemporalState",
    "UmeTrackNet",
    "memory_motion_transform",
]
