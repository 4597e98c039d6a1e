"""Hand model: 22-DoF kinematic skeleton, 21 landmarks, 17 skinning frames.

Counterpart of ``umetrack_tpu/kinematics/hand.py`` as a dataclass of
tensors.  Fields may carry leading batch dims (one hand model per
sequence); ``map`` applies a function to every field, the way the JAX
package maps over its pytree.
"""
from __future__ import annotations

import dataclasses
import json
import os
from enum import Enum
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._tree import TensorTree

NUM_HANDS = 2
NUM_LANDMARKS_PER_HAND = 21
NUM_FINGERTIPS_PER_HAND = 5
NUM_JOINTS_PER_HAND = 22
LEFT_HAND_INDEX = 0
RIGHT_HAND_INDEX = 1
NUM_DIGITS = 5
NUM_JOINT_FRAMES = 1 + 1 + 3 * 5  # root + wrist + 3 frames per digit
DOF_PER_FINGER = 4

# The generic hand of the benchmark: its own copy of the repository's
# ``assets/generic_hand_model.json``, so the traffic never follows an edit.
GENERIC_HAND_JSON = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "assets", "generic_hand_model.json",
)


class Landmark(Enum):
    """The 21 landmarks of a hand, by index."""

    THUMB_FINGERTIP = 0
    INDEX_FINGER_FINGERTIP = 1
    MIDDLE_FINGER_FINGERTIP = 2
    RING_FINGER_FINGERTIP = 3
    PINKY_FINGER_FINGERTIP = 4
    WRIST_JOINT = 5
    THUMB_INTERMEDIATE_FRAME = 6
    THUMB_DISTAL_FRAME = 7
    INDEX_PROXIMAL_FRAME = 8
    INDEX_INTERMEDIATE_FRAME = 9
    INDEX_DISTAL_FRAME = 10
    MIDDLE_PROXIMAL_FRAME = 11
    MIDDLE_INTERMEDIATE_FRAME = 12
    MIDDLE_DISTAL_FRAME = 13
    RING_PROXIMAL_FRAME = 14
    RING_INTERMEDIATE_FRAME = 15
    RING_DISTAL_FRAME = 16
    PINKY_PROXIMAL_FRAME = 17
    PINKY_INTERMEDIATE_FRAME = 18
    PINKY_DISTAL_FRAME = 19
    PALM_CENTER = 20


@dataclasses.dataclass
class HandModel(TensorTree):
    joint_rotation_axes: torch.Tensor  # [..., 22, 3]
    joint_rest_positions: torch.Tensor  # [..., 22, 3]
    landmark_rest_positions: torch.Tensor  # [..., 21, 3]
    landmark_rest_bone_weights: torch.Tensor  # [..., 21, K]
    landmark_rest_bone_indices: torch.Tensor  # [..., 21, K] int64
    joint_limits: Optional[torch.Tensor] = None  # [..., 22, 2]
    hand_scale: Optional[torch.Tensor] = None  # [...]

    @property
    def batch_shape(self) -> torch.Size:
        return self.joint_rotation_axes.shape[:-2]

    def unsqueeze_batch(self, n: int = 1) -> "HandModel":
        """Insert ``n`` singleton dims after the batch dims, so the model
        broadcasts against poses with ``n`` more leading dims."""
        b = len(self.batch_shape)
        return self.map(lambda a: a.reshape(*a.shape[:b], *([1] * n), *a.shape[b:]))


def from_dict(
    d: Dict[str, Any],
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> HandModel:
    """Build a HandModel from the label-JSON / msgpack dict schema."""

    def arr(key, as_int=False):
        if d.get(key) is None:
            return None
        a = np.asarray(d[key])
        return torch.as_tensor(
            a, dtype=torch.int64 if as_int else dtype, device=device
        )

    return HandModel(
        joint_rotation_axes=arr("joint_rotation_axes"),
        joint_rest_positions=arr("joint_rest_positions"),
        landmark_rest_positions=arr("landmark_rest_positions"),
        landmark_rest_bone_weights=arr("landmark_rest_bone_weights"),
        landmark_rest_bone_indices=arr("landmark_rest_bone_indices", as_int=True),
        joint_limits=arr("joint_limits"),
        hand_scale=arr("hand_scale"),
    )


def load_hand_model_json(
    path: str, device: torch.device | str = "cpu", dtype: torch.dtype = torch.float32
) -> HandModel:
    """The hand model of a label-schema JSON file (JAX ``load_hand_model_json``)."""
    with open(path) as fp:
        return from_dict(json.load(fp), device=device, dtype=dtype)


def load_generic_hand_dict(path: str = GENERIC_HAND_JSON) -> Dict[str, Any]:
    with open(path) as fp:
        return json.load(fp)


def stack_hand_models(hands) -> HandModel:
    """Stack same-shaped hand models along a new leading dim."""
    return HandModel(**{
        f.name: None if getattr(hands[0], f.name) is None
        else torch.stack([getattr(h, f.name) for h in hands])
        for f in dataclasses.fields(HandModel)
    })


def scaled_hand_model(hand: HandModel, multiplier) -> HandModel:
    """Uniformly scale the rest geometry (``multiplier`` broadcasts over the
    hand's batch dims)."""
    if isinstance(multiplier, (int, float)):  # as is: no host-to-device copy
        m = float(multiplier)
    else:
        m = torch.as_tensor(
            multiplier, dtype=hand.joint_rest_positions.dtype,
            device=hand.joint_rest_positions.device,
        )[..., None, None]
    return dataclasses.replace(
        hand,
        joint_rest_positions=hand.joint_rest_positions * m,
        landmark_rest_positions=hand.landmark_rest_positions * m,
    )


def mirrored_hand_model(hand: HandModel, to_mirror) -> HandModel:
    """Mirror right hands into left-hand canonical space: where
    ``to_mirror`` (a boolean mask over the leading batch dims) is true, the
    rotation axes' y/z components and the rest positions' x components are
    negated."""
    ref = hand.joint_rotation_axes
    m = torch.as_tensor(to_mirror, dtype=torch.bool, device=ref.device)[..., None, None]

    def flip(a, sign):
        return torch.where(m, a * torch.tensor(sign, dtype=a.dtype, device=a.device), a)

    return dataclasses.replace(
        hand,
        joint_rotation_axes=flip(hand.joint_rotation_axes, [1.0, -1.0, -1.0]),
        joint_rest_positions=flip(hand.joint_rest_positions, [-1.0, 1.0, 1.0]),
        landmark_rest_positions=flip(hand.landmark_rest_positions, [-1.0, 1.0, 1.0]),
    )


def neutral_joint_angles(hand: HandModel, lower_factor: float = 0.5) -> torch.Tensor:
    """Mid-joint-limit pose used for crop-point generation."""
    lim = hand.joint_limits
    return lim[..., 0] * lower_factor + lim[..., 1] * (1.0 - lower_factor)
