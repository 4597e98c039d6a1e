"""Forward kinematics + linear-blend skinning on tensors.

Counterpart of ``umetrack_tpu/kinematics/skinning.py``.  The five digit
chains run as ``DOF_PER_FINGER`` batched [5, 4, 4] matmuls.  The hand
model's batch dims broadcast against the pose's, so one call covers every
(sequence, frame, hand) at once.

Frame layout: 17 frames = [root, wrist, digit0_frame1..3, ...,
digit4_frame1..3], where each digit contributes the transforms after
applying 2, 3 and 4 of its joints.
"""
from __future__ import annotations

import torch

from ..geometry import affine
from .hand import DOF_PER_FINGER, NUM_DIGITS, NUM_JOINT_FRAMES, HandModel


def joint_local_transforms(
    rotation_axes: torch.Tensor,  # [..., J, 3]
    rest_positions: torch.Tensor,  # [..., J, 3]
    joint_angles: torch.Tensor,  # [..., J]
) -> torch.Tensor:  # [..., J, 4, 4]
    """Rotation about each joint's axis, pivoting at its rest position."""
    rot = affine.rodrigues(rotation_axes * joint_angles[..., None])
    trans = rest_positions - (rot @ rest_positions[..., None])[..., 0]
    return affine.compose_rigid(rot, trans)


def hand_skinning_transforms(
    rotation_axes: torch.Tensor,  # [..., 22, 3]
    rest_positions: torch.Tensor,  # [..., 22, 3]
    joint_angles: torch.Tensor,  # [..., 22]
    wrist_transform: torch.Tensor,  # [..., 4, 4]
) -> torch.Tensor:  # [..., 17, 4, 4]
    local = joint_local_transforms(
        rotation_axes[..., :20, :], rest_positions[..., :20, :],
        joint_angles[..., :20],
    )
    local = local.reshape(*local.shape[:-3], NUM_DIGITS, DOF_PER_FINGER, 4, 4)
    m = wrist_transform[..., None, :, :]
    chain = []
    for j in range(DOF_PER_FINGER):
        m = m @ local[..., j, :, :]
        chain.append(m)
    digits = torch.stack(chain[1:], dim=-3)  # [..., 5, 3, 4, 4]
    digits = digits.reshape(
        *digits.shape[:-4], NUM_DIGITS * (DOF_PER_FINGER - 1), 4, 4
    )
    root = wrist_transform[..., None, :, :].expand(*digits.shape[:-3], 2, 4, 4)
    return torch.cat([root, digits], dim=-3)


def skinning_weight_matrix(
    bone_indices: torch.Tensor,  # [..., V, K] int
    bone_weights: torch.Tensor,  # [..., V, K]
    n_frames: int = NUM_JOINT_FRAMES,
) -> torch.Tensor:  # [..., V, n_frames]
    """Sparse (index, weight) pairs -> dense per-frame weights; zero
    weights contribute nothing, and an out-of-range index selects no frame."""
    frame_ids = torch.arange(n_frames, device=bone_indices.device)
    onehot = (bone_indices[..., None] == frame_ids).to(bone_weights.dtype)
    return (bone_weights[..., None] * onehot).sum(dim=-2)


def skin_points(
    frames: torch.Tensor,  # [..., 17, 4, 4]
    weights: torch.Tensor,  # [..., V, 17]
    points: torch.Tensor,  # [..., V, 3]
) -> torch.Tensor:  # [..., V, 3]
    """LBS: blend the frame transforms per point, then apply."""
    blended = weights @ frames.flatten(-2)  # [..., V, 16]
    blended = blended.unflatten(-1, (4, 4))
    return affine.transform3(blended, points)


def skin_landmarks(
    hand: HandModel,
    joint_angles: torch.Tensor,  # [..., 22]
    wrist_transforms: torch.Tensor,  # [..., 4, 4]
) -> torch.Tensor:  # [..., 21, 3]
    """Landmark positions; the hand model's batch dims broadcast against the
    pose's."""
    frames = hand_skinning_transforms(
        hand.joint_rotation_axes, hand.joint_rest_positions, joint_angles,
        wrist_transforms,
    )
    weights = skinning_weight_matrix(
        hand.landmark_rest_bone_indices, hand.landmark_rest_bone_weights
    )
    return skin_points(frames, weights, hand.landmark_rest_positions)
