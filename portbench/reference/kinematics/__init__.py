from . import hand, skinning
from .hand import (
    HandModel,
    Landmark,
    NUM_HANDS,
    NUM_JOINTS_PER_HAND,
    NUM_JOINT_FRAMES,
    NUM_LANDMARKS_PER_HAND,
    from_dict,
    load_generic_hand_dict,
    load_hand_model_json,
    mirrored_hand_model,
    neutral_joint_angles,
    scaled_hand_model,
    stack_hand_models,
)
from .skinning import skin_landmarks

__all__ = [
    "hand",
    "skinning",
    "HandModel",
    "Landmark",
    "NUM_HANDS",
    "NUM_JOINTS_PER_HAND",
    "NUM_JOINT_FRAMES",
    "NUM_LANDMARKS_PER_HAND",
    "from_dict",
    "load_generic_hand_dict",
    "load_hand_model_json",
    "mirrored_hand_model",
    "neutral_joint_angles",
    "scaled_hand_model",
    "stack_hand_models",
    "skin_landmarks",
]
