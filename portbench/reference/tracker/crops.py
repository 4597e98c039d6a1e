"""Crop-camera generation from GT poses, mask-based and batched.

Counterpart of ``umetrack_tpu/tracker/crops.py``:

- 63 crop points = landmarks of the GT pose + neutral (mid-limit) pose +
  open (zero) pose;
- per-camera visibility count over the 21 GT landmarks; a camera is
  eligible with >= ``min_required_vis_landmarks`` in view;
- the first ``max_views`` eligible cameras by index are taken (a masked
  sort over camera indices);
- per selected camera a pinhole crop camera is fitted (look-at + focal fit,
  x-mirrored for right hands); fit failures mask the view.

Every function runs over arbitrary leading frame dims ``[...]`` at once
(the JAX package vmaps); the rig's and the hand model's batch dims must
broadcast against them.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._device import device_constant
from ..geometry import affine
from ..geometry.cameras import arctan_project, fisheye62_distort
from ..geometry.crop import gen_crop_camera_from_points
from ..kinematics.hand import HandModel, neutral_joint_angles
from ..kinematics.skinning import skin_landmarks
from .types import CameraRig, CropSet, TrackerConfig

_BIG = 10_000


def _mirror_x_column(xf: torch.Tensor, hand_idx: torch.Tensor) -> torch.Tensor:
    """Multiply the x basis column of ``xf [..., 4, 4]`` by -1 where
    ``hand_idx == 1`` (right hands)."""
    sign = torch.where(hand_idx == 1, -1.0, 1.0).to(xf.dtype)
    ones = torch.ones_like(sign)
    return xf * torch.stack([sign, ones, ones, ones], dim=-1)[..., None, :]


def landmarks_from_pose(
    hand_model: HandModel,
    joint_angles: torch.Tensor,  # [..., 22]
    wrist_xf: torch.Tensor,  # [..., 4, 4]
    hand_idx: torch.Tensor,  # [...] int
) -> torch.Tensor:  # [..., 21, 3]
    """World landmarks; the left-hand model's wrist x-axis is mirrored for
    right hands."""
    return skin_landmarks(hand_model, joint_angles, _mirror_x_column(wrist_xf, hand_idx))


def static_crop_points_local(
    hand_model: HandModel, num_crop_points: int
) -> Optional[torch.Tensor]:
    """Wrist-local landmarks of the pose-independent crop poses (neutral =
    mid joint limits, open = zero angles), pre-mirrored per hand:
    ``[..., 2, n_extra, 3]`` over the hand model's batch dims, or None when
    only the GT landmarks are used.  FK is rigid in the wrist, so per frame
    these sets cost one transform instead of two skinnings."""
    if num_crop_points <= 21:
        return None
    ref = hand_model.joint_rest_positions
    eye = torch.eye(4, dtype=ref.dtype, device=ref.device).expand(*hand_model.batch_shape, 4, 4)
    sets = [neutral_joint_angles(hand_model)]
    if num_crop_points > 42:
        sets.append(torch.zeros_like(sets[0]))
    local = torch.cat([skin_landmarks(hand_model, a, eye) for a in sets], dim=-2)
    right = local * device_constant([-1.0, 1.0, 1.0], local.dtype, local.device)
    return torch.stack([local, right], dim=-3)


def gather_cameras(a: torch.Tensor, idx: torch.Tensor, n_trailing: int = 0) -> torch.Tensor:
    """``a [..., N, *trailing]`` indexed along N by ``idx [..., K]`` ->
    ``[..., K, *trailing]``; the batch dims of the two broadcast."""
    trailing = a.shape[a.dim() - n_trailing:]
    n = a.shape[a.dim() - n_trailing - 1]
    batch = torch.broadcast_shapes(a.shape[:a.dim() - n_trailing - 1], idx.shape[:-1])
    a_b = a.expand(*batch, n, *trailing)
    k = idx.shape[-1]
    index = idx.to(torch.int64).expand(*batch, k)
    index = index.reshape(*batch, k, *([1] * n_trailing)).expand(*batch, k, *trailing)
    return torch.gather(a_b, len(batch), index)


def _visibility_counts(
    rig: CameraRig,  # fields [..., N]
    T_world_from_camera: torch.Tensor,  # [..., N, 4, 4]
    landmarks_world: torch.Tensor,  # [..., 21, 3]
) -> torch.Tensor:  # [..., N] int32
    """Landmarks in view per camera."""
    w2e = affine.rigid_inverse(T_world_from_camera)
    eye = affine.transform3(w2e[..., :, None, :, :], landmarks_world[..., None, :, :])
    q = fisheye62_distort(rig.coeffs[..., None, :], arctan_project(eye))
    f = torch.stack([rig.fx, rig.fy], dim=-1)[..., None, :]
    c = torch.stack([rig.cx, rig.cy], dim=-1)[..., None, :]
    win = q * f + c
    vis = (
        (win[..., 0] >= 0)
        & (win[..., 0] <= rig.width[..., None] - 1)
        & (win[..., 1] >= 0)
        & (win[..., 1] <= rig.height[..., None] - 1)
        & (eye[..., 2] > 0)
    )
    return vis.sum(dim=-1).to(torch.int32)


def gen_crops_for_hand(
    rig: CameraRig,
    T_world_from_camera: torch.Tensor,  # [..., N, 4, 4]
    hand_model: HandModel,  # mm, left hand
    joint_angles: torch.Tensor,  # [..., 22]
    wrist_xf: torch.Tensor,  # [..., 4, 4] mm
    confidence: torch.Tensor,  # [...]
    hand_idx: int,
    config: TrackerConfig,
    min_num_crops: int,
    static_pts_local: Optional[torch.Tensor] = None,  # [..., n_extra, 3]
):
    """Crop cameras for one hand, as the JAX package's per-hand function
    returns them: (intrinsics [..., V, 3, 3], T_world_from_eye
    [..., V, 4, 4], src_idx [..., V], view_valid [..., V], hand_valid [...],
    n_views [...]).  :func:`gen_crop_set` with the pose in both hand slots,
    read at ``hand_idx``."""
    h = int(hand_idx)
    both = gen_crop_set(
        rig, T_world_from_camera, hand_model,
        torch.stack([joint_angles] * 2, dim=-2),
        torch.stack([wrist_xf] * 2, dim=-3),
        torch.stack([torch.as_tensor(confidence, device=joint_angles.device)] * 2, dim=-1),
        config, min_num_crops,
        None if static_pts_local is None else torch.stack([static_pts_local] * 2, dim=-3),
    )
    return (
        both.intrinsics.select(-4, h), both.T_world_from_eye.select(-4, h),
        both.src_cam_idx.select(-2, h), both.view_valid.select(-2, h),
        both.hand_valid.select(-1, h), both.n_views.select(-1, h),
    )


def gen_crop_set(
    rig: CameraRig,  # fields [..., N] (batch dims broadcast to the frames')
    T_world_from_camera: torch.Tensor,  # [..., N, 4, 4]
    hand_model: HandModel,  # mm, left hand; batch dims broadcast
    gt_joint_angles: torch.Tensor,  # [..., 2, 22]
    gt_wrist_xfs: torch.Tensor,  # [..., 2, 4, 4]
    gt_confidences: torch.Tensor,  # [..., 2]
    config: TrackerConfig,
    min_num_crops: int,
    static_pts_local: Optional[torch.Tensor] = None,  # [..., 2, n_extra, 3]
) -> CropSet:
    """Dense 2-hand crop sets for every frame of ``[...]``.
    ``static_pts_local`` (from :func:`static_crop_points_local`) is computed
    here when not given."""
    device = gt_joint_angles.device
    hand_idx = torch.arange(2, device=device)
    # add the hand dim to everything that has none
    rig_h = rig.unsqueeze_batch(1)
    t_wc_h = T_world_from_camera[..., None, :, :, :]
    hand_h = hand_model.unsqueeze_batch(1)

    lm = landmarks_from_pose(hand_h, gt_joint_angles, gt_wrist_xfs, hand_idx)
    eligible = _visibility_counts(rig_h, t_wc_h, lm) >= config.min_required_vis_landmarks

    n = rig.num_cameras
    key = torch.where(eligible, torch.arange(n, device=device), _BIG)
    order = torch.sort(key, dim=-1).values[..., : config.max_views]
    slot_has_cam = order < _BIG
    src_idx = torch.where(slot_has_cam, order, 0).to(torch.int32)  # [..., 2, V]

    if static_pts_local is None:
        static_pts_local = static_crop_points_local(hand_model, config.num_crop_points)
    if static_pts_local is None:
        crop_pts = lm
    else:
        extra = affine.transform3(gt_wrist_xfs[..., None, :, :], static_pts_local)
        crop_pts = torch.cat([lm, extra], dim=-2)  # [..., 2, P, 3]

    crops = gen_crop_camera_from_points(
        gather_cameras(t_wc_h, src_idx, 2),
        crop_pts[..., None, :, :],
        config.crop_size,
        mirror_img_x=(hand_idx == 1)[:, None],
        camera_angle_deg=gather_cameras(rig_h.camera_angles, src_idx),
        focal_multiplier=config.hand_ratio_in_crop,
    )
    view_valid = slot_has_cam & crops.valid

    # Pack valid views to the front (stable), so slot 0 is always the
    # sample's reference cam0.
    pack = torch.argsort((~view_valid).to(torch.int8), dim=-1, stable=True)

    def packed(a, n_trailing=0):
        return gather_cameras(a, pack, n_trailing)

    view_valid = packed(view_valid)
    n_views = view_valid.sum(dim=-1).to(torch.int32)
    hand_valid = (gt_confidences >= config.confidence_threshold) & (n_views >= min_num_crops)
    return CropSet(
        intrinsics=packed(crops.intrinsics_matrix(), 2),
        T_world_from_eye=packed(crops.T_world_from_eye, 2),
        src_cam_idx=packed(src_idx),
        view_valid=view_valid,
        hand_valid=hand_valid,
        n_views=n_views,
    )
