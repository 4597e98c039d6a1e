"""torch_data preprocessing: msgpack labels -> device-ready model sequences.

Counterpart of ``umetrack_tpu/data/transform.py``.  The loader only parses
bytes into numpy leaves; the whole crop + resample chain (per-frame crop
cameras from enclosing points, pixel homographies, the batched bilinear
warp, mm -> m) runs on the device, over one sequence ``[T, ...]`` or a
batch of sequences ``[B, T, ...]`` at once (the JAX package's ``vmap`` is a
leading dim here), with ONE sampler call for all ``B*T*V`` images.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._tree import TensorTree
from ..geometry import affine
from ..geometry.crop import gen_crop_camera_from_points
from ..kinematics.hand import HandModel, from_dict, mirrored_hand_model, scaled_hand_model
from ..ops.resample import resample_images

MM_TO_M = 0.001


@dataclasses.dataclass
class RawSequence(TensorTree):
    """One parsed torch_data sequence (units: mm, as stored).  Leaves are
    numpy arrays on the host and tensors once on the device; a batch adds
    one leading dim to every leaf."""

    images: Any  # [T, V, H, W]
    extrinsics: Any  # [T, V, 4, 4] world->eye
    intrinsics: Any  # [T, V, 3, 3]
    enclosing_points: Any  # [T, P, 3]
    hand: Any  # [T] hand index
    hand_model: HandModel  # GT user skeleton (no time dim)
    wrist: Any  # [T, 4, 4]
    joint_angles: Any  # [T, 22]
    solved_wrist_xfs: Any  # [T, 4, 4]
    solved_joint_angles: Any  # [T, 22]
    generic_hand_model: HandModel
    pinch: Any  # [T]


@dataclasses.dataclass
class PoseData(TensorTree):
    joint_angles: torch.Tensor  # [T, 22]
    wrist_xfs: torch.Tensor  # [T, 4, 4] (meters)
    left_hand_model: HandModel  # left-mirrored, meters (no time dim)


@dataclasses.dataclass
class ModelInput(TensorTree):
    orig_pose_data: PoseData
    s_solved_pose_data: PoseData
    left_images: torch.Tensor  # [T, V, h, w] in [0, 1]
    intrinsics: torch.Tensor  # [T, V, 3, 3]
    extrinsics_xf: torch.Tensor  # [T, V, 4, 4] world->eye, meters
    hand_idx: torch.Tensor  # [T]


@dataclasses.dataclass
class ModelTarget(TensorTree):
    gt_joint_angles: torch.Tensor
    gt_wrist_xfs: torch.Tensor
    gt_scale: Optional[torch.Tensor]
    solved_joint_angles: torch.Tensor
    solved_wrist_xfs: torch.Tensor
    solved_scale: Optional[torch.Tensor]
    pinch: torch.Tensor


def _hand_model_np(d: Dict[str, Any]) -> HandModel:
    return from_dict(d).map(lambda a: a.numpy())


def parse_raw_buffers(mono: np.ndarray, labels: Dict[str, Any]) -> RawSequence:
    """msgpack label dict + mono tensor -> typed RawSequence.

    Host-side only: every leaf is a numpy array, so the parse can run inside
    prefetch worker threads; the upload happens once per batch."""
    def np32(key):
        return np.asarray(labels[key], np.float32)

    return RawSequence(
        images=np.asarray(mono),
        extrinsics=np32("extrinsics"),
        intrinsics=np32("intrinsics"),
        enclosing_points=np32("enclosing_points"),
        hand=np32("hand"),
        hand_model=_hand_model_np(labels["hand_model"]),
        wrist=np32("wrist"),
        joint_angles=np32("joint_angles"),
        solved_wrist_xfs=np32("solved_wrist_xfs"),
        solved_joint_angles=np32("solved_joint_angles"),
        generic_hand_model=_hand_model_np(labels["generic_hand_model"]),
        pinch=np32("pinch"),
    )


def _pinhole_k44(intr: torch.Tensor) -> torch.Tensor:
    """Embed a 3x3 pinhole K into 4x4."""
    out = torch.zeros((*intr.shape[:-2], 4, 4), dtype=intr.dtype, device=intr.device)
    out[..., :3, :3] = intr
    out[..., 3, 3] = 1.0
    return out


def _pinhole_k44_inv(intr: torch.Tensor) -> torch.Tensor:
    fx, fy = intr[..., 0, 0], intr[..., 1, 1]
    cx, cy = intr[..., 0, 2], intr[..., 1, 2]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    rows = [
        torch.stack([1.0 / fx, z, -cx / fx, z], dim=-1),
        torch.stack([z, 1.0 / fy, -cy / fy, z], dim=-1),
        torch.stack([z, z, o, z], dim=-1),
        torch.stack([z, z, z, o], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _translation_to_m(xf: torch.Tensor) -> torch.Tensor:
    out = xf.clone()
    out[..., :3, 3] *= MM_TO_M
    return out


def crop_homographies(
    raw: RawSequence,  # tensor leaves [..., T, ...]
    crop_size: Tuple[int, int] = (96, 96),
    focal_multiplier: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-(frame, view) crop cameras from the frame's enclosing points:
    their intrinsics [..., T, V, 3, 3], world->eye transforms [..., T, V, 4, 4]
    (meters) and the dst-pixel -> src-pixel homographies [..., T, V, 4, 4]
    that warp each raw view into its crop."""
    extr = _translation_to_m(raw.extrinsics)
    is_right = raw.hand[..., 0] == 1  # one hand per sequence
    crops = gen_crop_camera_from_points(
        affine.rigid_inverse(extr),  # [..., T, V, 4, 4]
        (raw.enclosing_points * MM_TO_M)[..., :, None, :, :],  # [..., T, 1, P, 3]
        crop_size,
        mirror_img_x=is_right[..., None, None],
        camera_angle_deg=0.0,
        focal_multiplier=focal_multiplier,
    )
    new_k = crops.intrinsics_matrix()
    # K_orig @ world_to_eye_orig @ eye_to_world_new @ K_new^-1
    resample_xf = (
        _pinhole_k44(raw.intrinsics) @ extr @ crops.T_world_from_eye @ _pinhole_k44_inv(new_k)
    )
    return new_k, affine.rigid_inverse(crops.T_world_from_eye), resample_xf


@torch.no_grad()
def preprocess_sequence(
    raw: RawSequence,  # tensor leaves [T, ...] or [B, T, ...]
    crop_size: Tuple[int, int] = (96, 96),
    focal_multiplier: float = 0.95,
    sampler: Optional[str] = None,
) -> Tuple[ModelInput, ModelTarget]:
    """The device-side preprocess: mm -> m, left-mirrored hand models,
    per-(frame, view) crop cameras, and the homography resample of every
    view in one sampler call (``sampler`` as in
    :func:`~umetrack_torch.ops.resample.bilinear_sample`).  uint8 frames
    are sampled as they are, without a float copy."""
    lead = raw.images.shape[:-4]
    t, v = raw.images.shape[-4:-2]

    wrist = _translation_to_m(raw.wrist)
    solved_wrist = _translation_to_m(raw.solved_wrist_xfs)
    is_right = raw.hand[..., 0] == 1
    left_hand_model = mirrored_hand_model(scaled_hand_model(raw.hand_model, MM_TO_M), is_right)
    left_generic = mirrored_hand_model(
        scaled_hand_model(raw.generic_hand_model, MM_TO_M), is_right
    )

    new_k, new_w2e, resample_xf = crop_homographies(raw, crop_size, focal_multiplier)
    n = lead.numel() * t * v
    warped = resample_images(
        raw.images.reshape(n, *raw.images.shape[-2:]),
        resample_xf.reshape(n, 4, 4),
        crop_size,
        sampler,
    ).reshape(*lead, t, v, *crop_size)
    left_images = warped / 255.0

    model_input = ModelInput(
        orig_pose_data=PoseData(
            joint_angles=raw.joint_angles, wrist_xfs=wrist, left_hand_model=left_hand_model,
        ),
        s_solved_pose_data=PoseData(
            joint_angles=raw.solved_joint_angles, wrist_xfs=solved_wrist,
            left_hand_model=left_generic,
        ),
        left_images=left_images,
        intrinsics=new_k,
        extrinsics_xf=new_w2e,
        hand_idx=raw.hand,
    )
    target = ModelTarget(
        gt_joint_angles=raw.joint_angles,
        gt_wrist_xfs=wrist,
        gt_scale=left_hand_model.hand_scale,
        solved_joint_angles=raw.solved_joint_angles,
        solved_wrist_xfs=solved_wrist,
        solved_scale=left_generic.hand_scale,
        pinch=raw.pinch,
    )
    return model_input, target


def preprocess(
    data: Dict[str, Any], crop_size: Tuple[int, int] = (96, 96), device=None,
) -> Tuple[ModelInput, ModelTarget]:
    """Loader-facing entry: ``{"mono": ndarray, "labels": msgpack dict}``,
    on the GPU unless ``device="cpu"``."""
    from .._device import resolve_device
    from .bundles import to_device

    raw = parse_raw_buffers(data["mono"], data["labels"])
    return preprocess_sequence(to_device(raw, resolve_device(device)), crop_size)
