"""Tracker data structures: a static config plus dataclasses of tensors: 2 hand slots x V view
slots with validity masks.  Every tensor dataclass can ``map`` a function
over its fields and move to a device with ``to``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._tree import TensorTree
from ..models.umetrack import TemporalState

MM_TO_M = 0.001
M_TO_MM = 1000.0


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Static tracker knobs (the plain path has one sampler, the plain pool
    sampler)."""

    num_crop_points: int = 63  # 21 (gt) / 42 (+neutral) / 63 (+open)
    enable_memory: bool = True
    hand_ratio_in_crop: float = 0.95  # focal multiplier
    min_required_vis_landmarks: int = 19
    confidence_threshold: float = 0.5
    max_views: int = 2
    crop_size: Tuple[int, int] = (96, 96)


@dataclasses.dataclass
class CameraRig(TensorTree):
    """N fisheye cameras, fields ``[..., N]`` (``coeffs [..., N, 8]``, the
    fisheye62 k1 k2 k3 k4 p1 p2 k5 k6); ``camera_angles`` is the mounting
    roll in degrees."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    coeffs: torch.Tensor
    camera_angles: torch.Tensor

    @property
    def num_cameras(self) -> int:
        return self.fx.shape[-1]

    def unsqueeze_batch(self, n: int = 1) -> "CameraRig":
        """Insert ``n`` singleton dims after the batch dims."""
        b = self.fx.dim() - 1
        return self.map(lambda a: a.reshape(*a.shape[:b], *([1] * n), *a.shape[b:]))


@dataclasses.dataclass
class FrameObservation(TensorTree):
    """Frames of input (any leading batch dims ``[...]``):

    * images: [..., N, H, W] uint8 (or float) raw per-camera views
    * T_world_from_camera: [..., N, 4, 4] camera poses (mm world)
    * gt_joint_angles: [..., 2, 22]
    * gt_wrist_xfs: [..., 2, 4, 4] (mm, left-hand convention)
    * gt_confidences: [..., 2]
    """

    images: torch.Tensor
    T_world_from_camera: torch.Tensor
    gt_joint_angles: torch.Tensor
    gt_wrist_xfs: torch.Tensor
    gt_confidences: torch.Tensor


@dataclasses.dataclass
class TrackState(TensorTree):
    """Carry: temporal memory (one row per hand) + per-hand history flags."""

    temporal: TemporalState
    valid_history: torch.Tensor  # [B] bool

    @staticmethod
    def init(config, batch: int = 2, device="cpu") -> "TrackState":
        return TrackState(
            temporal=TemporalState.zeros(batch, config, device=device),
            valid_history=torch.zeros((batch,), dtype=torch.bool, device=device),
        )


@dataclasses.dataclass
class CropSet(TensorTree):
    """Dense crop cameras: [..., 2 hands, V views] slots + masks."""

    intrinsics: torch.Tensor  # [..., 2, V, 3, 3]
    T_world_from_eye: torch.Tensor  # [..., 2, V, 4, 4] (mm world)
    src_cam_idx: torch.Tensor  # [..., 2, V] int32 source camera per slot
    view_valid: torch.Tensor  # [..., 2, V] bool (valid views packed first)
    hand_valid: torch.Tensor  # [..., 2] bool
    n_views: torch.Tensor  # [..., 2] int32


@dataclasses.dataclass
class FrameResult(TensorTree):
    """Tracking output in mm world space, ``[T, 2, ...]`` or ``[T, S, 2, ...]``."""

    joint_angles: torch.Tensor  # [..., 22]
    wrist_xfs: torch.Tensor  # [..., 4, 4] (translation mm)
    valid: torch.Tensor  # [...] bool
    n_views: torch.Tensor  # [...] int32
    predicted_scales: Optional[torch.Tensor] = None  # [...] (scale head only)
