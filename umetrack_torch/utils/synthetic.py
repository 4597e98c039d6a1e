"""Synthetic multi-view sequences (a small copy of the JAX package's
``utils/synthetic.py``).

A 4-camera fisheye rig around a hand-sized workspace, GT poses animated
from the generic hand model (scipy rotations), and smooth-noise images made
with ``torch.nn.functional.interpolate(mode="bicubic")``.  The hands are
not rendered into the images: the tracker's crops, warps and model run on
the noise all the same.  :func:`make_torchdata_sample` and
:func:`write_torchdata_corpus` make the same kind of data in the torch_data
schema (pinhole views, msgpack labels, idx/bin files on disk).
"""
from __future__ import annotations

import os

import numpy as np
import torch
from torch.nn import functional as F

from .._device import resolve_device
from ..kinematics.hand import (
    from_dict,
    load_generic_hand_dict,
    mirrored_hand_model,
    stack_hand_models,
)
from ..kinematics.skinning import skin_landmarks
from ..tracker.types import CameraRig, FrameObservation
from ..tracker.video import rig_from_labels

CAM_JS = {
    "ImageSizeX": 640,
    "ImageSizeY": 480,
    "DistortionModel": "FishEye62",
    "fx": 275.0,
    "fy": 275.0,
    "cx": 319.5,
    "cy": 239.5,
    "k1": 0.35,
    "k2": 0.27,
    "k3": -0.5,
    "k4": 0.4,
    "p1": 1e-4,
    "p2": -2e-4,
    "k5": 0.0,
    "k6": 0.0,
}
N_CAMS = 4
CAMERA_ANGLES = [0.0, 0.0, 180.0, 180.0]

CAM_POSITIONS = np.array(
    [
        [-120.0, -60.0, -430.0],
        [120.0, -60.0, -430.0],
        [-150.0, 80.0, -410.0],
        [150.0, 80.0, -410.0],
    ]
)


def look_at_pose(position, target):
    """Camera-to-world with +z looking from position toward target."""
    z = target - position
    z = z / np.linalg.norm(z)
    up = np.array([0.0, 1.0, 0.0])
    if abs(np.dot(z, up)) > 0.95:
        up = np.array([1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0] = x
    m[:3, 1] = y
    m[:3, 2] = z
    m[:3, 3] = position
    return m


def make_camera_poses(target=None):
    """Four cameras ~450 mm out, looking at ``target`` (default origin; mm)."""
    target = np.zeros(3) if target is None else np.asarray(target, np.float64)
    return np.stack([look_at_pose(p, target) for p in CAM_POSITIONS]).astype(np.float32)


def make_gt_motion(rng, t, hand_dict, mode: str = "separate"):
    """GT joint angles [T, 2, 22], wrist transforms [T, 2, 4, 4] and
    confidences [T, 2] for two hands: wrists hover near the origin with slow
    translation and rotation, angles swing inside the joint limits, and hand
    1's confidence drops out for 3 frames a third of the way in.
    ``mode="hand_hand"`` drives the hands through each other's position."""
    from scipy.spatial.transform import Rotation

    limits = np.asarray(hand_dict["joint_limits"], np.float32)  # [22, 2]
    angles = np.zeros((t, 2, 22), np.float32)
    wrists = np.zeros((t, 2, 4, 4), np.float32)
    conf = np.ones((t, 2), np.float32)

    for hand in range(2):
        phase = rng.uniform(0, 2 * np.pi, size=22)
        freq = rng.uniform(0.02, 0.08, size=22)
        mid = (limits[:, 0] + limits[:, 1]) / 2
        amp = (limits[:, 1] - limits[:, 0]) / 4
        for ti in range(t):
            angles[ti, hand] = mid + amp * np.sin(freq * ti + phase)

        sign = -1.0 if hand == 0 else 1.0
        if mode == "hand_hand":
            base_pos = np.array([sign * 25.0, sign * 10.0, 0.0])
        else:
            base_pos = np.array([sign * 60.0, 0.0, 0.0])
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        base_rot = Rotation.from_rotvec(rng.uniform(0, np.pi) * np.array([0, 0, 1.0]))
        for ti in range(t):
            r = Rotation.from_rotvec(axis * 0.02 * ti) * base_rot
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = r.as_matrix()
            wobble = np.array(
                [20 * np.sin(0.05 * ti), 15 * np.cos(0.04 * ti), 10 * np.sin(0.03 * ti)]
            )
            if mode == "hand_hand":
                wobble = wobble + np.array([-sign * 55.0 * np.sin(0.08 * ti), 0.0, 0.0])
            m[:3, 3] = base_pos + wobble
            wrists[ti, hand] = m

    lo = t // 3
    conf[lo: lo + 3, 1] = 0.0
    return angles, wrists, conf


def smooth_images(rng, t, n=N_CAMS, h=480, w=640, lo=40, hi=220, device="cpu"):
    """Smooth noise images, uint8 [T, N, H, W]: a 15 x 20 grid of uniform
    values per image, upsampled bicubically."""
    base = rng.uniform(lo, hi, size=(t * n, 1, 15, 20)).astype(np.float32)
    img = F.interpolate(
        torch.from_numpy(base).to(device), size=(h, w), mode="bicubic", align_corners=False
    )
    return img.clamp(0, 255).to(torch.uint8).reshape(t, n, h, w)


def our_sequence(labels: dict, images, device="cpu"):
    """Rig, observation (leading T axis) and hand model from a label dict in
    the raw_data JSON schema plus its images [T, N, H, W]."""

    def f32(key):
        return torch.tensor(np.asarray(labels[key], np.float32), device=device)

    seq = FrameObservation(
        images=torch.as_tensor(images).to(device),
        T_world_from_camera=f32("camera_to_world_transforms"),
        gt_joint_angles=f32("joint_angles"),
        gt_wrist_xfs=f32("wrist_transforms"),
        gt_confidences=f32("hand_confidences"),
    )
    return rig_from_labels(labels, device), seq, from_dict(labels["hand_model"], device)


def make_sequence(t: int, seed: int = 0, device=None):
    """A T-frame synthetic sequence on ``device`` (CUDA unless "cpu"):
    returns (rig, observation, hand model)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    hand_dict = load_generic_hand_dict()
    angles, wrists, conf = make_gt_motion(rng, t, hand_dict)
    images = smooth_images(rng, t, device=device)
    cam_poses = make_camera_poses()
    labels = {
        "cameras": [dict(CAM_JS) for _ in range(N_CAMS)],
        "camera_angles": CAMERA_ANGLES,
        "camera_to_world_transforms": np.tile(cam_poses, (t, 1, 1, 1)),
        "joint_angles": angles,
        "wrist_transforms": wrists,
        "hand_confidences": conf,
        "hand_model": hand_dict,
    }
    return our_sequence(labels, images, device)


def make_sequences(s: int, t: int, seed: int = 0, device=None):
    """S synthetic sequences of T frames (seeds ``seed .. seed+S-1``),
    stacked sequence-major: rig [S, ...], observation [S, T, ...] and hand
    models [S, ...]."""
    parts = [make_sequence(t, seed + i, device) for i in range(s)]

    def stack(trees, cls):
        return cls(**{
            k: torch.stack([getattr(tr, k) for tr in trees])
            for k in trees[0].__dataclass_fields__
        })

    rigs = stack([p[0] for p in parts], CameraRig)
    seqs = stack([p[1] for p in parts], FrameObservation)
    hands = stack_hand_models([p[2] for p in parts])
    return rigs, seqs, hands


def scaled_hand_dict(hand_dict: dict, scale: float) -> dict:
    """Uniformly scale a hand-model dict's rest geometry."""
    out = dict(hand_dict)
    for key in ("joint_rest_positions", "landmark_rest_positions"):
        out[key] = (np.asarray(hand_dict[key], np.float32) * scale).tolist()
    base = hand_dict.get("hand_scale")
    out["hand_scale"] = float(base if base is not None else 1.0) * scale
    return out


def mirrored_gt_landmarks(hand_dict, angles, wrists, is_right) -> np.ndarray:
    """World landmarks [T, 21, 3] (mm) in the torch_data convention: skin
    the per-sample mirrored hand model."""
    hand = mirrored_hand_model(from_dict(hand_dict), bool(is_right))
    return skin_landmarks(
        hand, torch.tensor(np.asarray(angles, np.float32)),
        torch.tensor(np.asarray(wrists, np.float32)),
    ).numpy()


def make_torchdata_sample(rng_seed=0, t=3, v=2, h=120, w=160, hand_idx=1, hand_scale=None):
    """A synthetic raw torch_data sample ``(mono [T, V, H, W] uint8, labels)``
    in the msgpack label schema: pinhole views aimed at the hand near the
    origin, mm units, smooth-noise frames (the hand is not drawn), GT motion
    from :func:`make_gt_motion`, and ``enclosing_points`` = the 63 crop
    points (GT + neutral + open pose landmarks).  The focal length grows
    with the frame width so the hand fills the same share of any size."""
    rng = np.random.default_rng(rng_seed)
    generic_dict = load_generic_hand_dict()
    hand_dict = generic_dict if hand_scale is None else scaled_hand_dict(generic_dict, hand_scale)

    motion_angles, motion_wrists, _ = make_gt_motion(rng, t, hand_dict)
    angles = motion_angles[:, hand_idx]  # [t, 22]
    wrist = motion_wrists[:, hand_idx]  # [t, 4, 4]

    # Aim the views at the hand's mean position so it stays inside the frames.
    center = wrist[:, :3, 3].mean(axis=0)
    cam_poses = make_camera_poses(target=center)[:v]  # [V, 4, 4] mm
    extr = np.stack([np.linalg.inv(p).astype(np.float32) for p in cam_poses])  # world->eye
    extr = np.tile(extr, (t, 1, 1, 1))

    intr = np.tile(np.eye(3, dtype=np.float32), (t, v, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = 1.25 * w
    intr[..., 0, 2] = (w - 1) / 2
    intr[..., 1, 2] = (h - 1) / 2
    solved_angles = angles + rng.normal(0, 0.05, size=(t, 22)).astype(np.float32)

    limits = np.asarray(hand_dict["joint_limits"], np.float32)
    neutral = np.broadcast_to((limits[:, 0] + limits[:, 1]) / 2, angles.shape)
    is_right = hand_idx == 1
    enclosing = np.concatenate(
        [
            mirrored_gt_landmarks(hand_dict, pose, wrist, is_right)
            for pose in (angles, neutral, np.zeros_like(angles))
        ],
        axis=1,
    ).astype(np.float32)  # [t, 63, 3]
    mono = smooth_images(rng, t, n=v, h=h, w=w).numpy()

    labels = {
        "extrinsics": extr.tolist(),
        "intrinsics": intr.tolist(),
        "enclosing_points": enclosing.tolist(),
        "hand": [float(hand_idx)] * t,
        "hand_model": hand_dict,
        "wrist": wrist.tolist(),
        "joint_angles": angles.tolist(),
        "solved_wrist_xfs": wrist.tolist(),
        "solved_joint_angles": solved_angles.tolist(),
        "generic_hand_model": generic_dict,
        "pinch": [0.0] * t,
    }
    return mono, labels


def write_torchdata_corpus(
    root: str, n_train: int = 0, n_test: int = 8, t: int = 16, v: int = 2,
    h: int = 120, w: int = 160, seed0: int = 0,
) -> dict:
    """Write a synthetic torch_data corpus to disk (``training`` and
    ``testing`` folders under ``root/synthetic/``, one idx/bin item per
    sequence), alternating hands and varying the GT hand scale per
    sequence.  Returns {split name: folder}."""
    from ..data.idxbin import write_idxbin

    out = {}
    for split, n, base in (("training", n_train, 0), ("testing", n_test, 50_000)):
        if n == 0:
            continue
        monos, labels_list = [], []
        for i in range(n):
            scale = float(np.random.default_rng(seed0 + base + i).uniform(0.85, 1.15))
            mono, labels = make_torchdata_sample(
                rng_seed=seed0 + base + i, t=t, v=v, h=h, w=w,
                hand_idx=i % 2, hand_scale=scale,
            )
            monos.append(mono)
            labels_list.append(labels)
        folder = os.path.join(root, "synthetic", split)
        write_idxbin(os.path.join(folder, "mono"), monos)
        write_idxbin(os.path.join(folder, "labels"), labels_list, msgpack_objects=True)
        out[split] = folder
    return out
