"""Synthetic multi-view sequences (the port's copy of the JAX package's
``utils/synthetic.py``).

A 4-camera fisheye rig around a hand-sized workspace, GT poses animated
from the generic hand model (scipy rotations), and smooth-noise images made
with ``torch.nn.functional.interpolate(mode="bicubic")``.
:func:`make_labels_dict` renders the GT hands into the fisheye views, so
the pose can be read from the pixels: ``"capsule"`` is the shaded capsule
ray tracer (``utils/render.py``), ``"strokes"`` the flat stroke renderer
(OpenCV, imported inside :func:`draw_hands_on_image` only).
:func:`make_sequence` leaves the hands out: the tracker's crops, warps and
model run on the noise all the same.  :func:`make_torchdata_sample` and
:func:`write_torchdata_corpus` make the same kind of data in the torch_data
schema (pinhole views, msgpack labels, idx/bin files on disk).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from .._device import resolve_device
from ..kinematics.hand import (  # noqa: F401 -- GENERIC_HAND_JSON: the JAX module's name
    GENERIC_HAND_JSON,
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

# Rendering style of make_labels_dict: "capsule" = the 3-D shaded capsule
# ray tracer (utils/render.py), "strokes" = the flat OpenCV stroke renderer.
DEFAULT_RENDER_STYLE = "capsule"

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


def smooth_images(rng, t, n=N_CAMS, h=480, w=640, lo=40, hi=220, device=None):
    """Smooth noise images, uint8 [T, N, H, W] on ``device`` (CUDA unless
    "cpu"): a 15 x 20 grid of uniform values per image, upsampled
    bicubically."""
    base = rng.uniform(lo, hi, size=(t * n, 1, 15, 20)).astype(np.float32)
    img = F.interpolate(
        torch.from_numpy(base).to(resolve_device(device)), size=(h, w), mode="bicubic",
        align_corners=False,
    )
    return img.clamp(0, 255).to(torch.uint8).reshape(t, n, h, w)


def our_sequence(labels: dict, images, device=None):
    """Rig, observation (leading T axis) and hand model on ``device`` (CUDA
    unless "cpu") from a label dict in the raw_data JSON schema plus its
    images [T, N, H, W]."""
    device = resolve_device(device)

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


# -- geometric hand rendering -------------------------------------------------

# Landmark topology for drawing: 0-4 fingertips (thumb..pinky), 5 wrist, 6-7
# thumb frames, 8-19 proximal/intermediate/distal frames per finger, 20 palm
# center.
_BONES = (
    (5, 6), (6, 7), (7, 0),
    (5, 8), (8, 9), (9, 10), (10, 1),
    (5, 11), (11, 12), (12, 13), (13, 2),
    (5, 14), (14, 15), (15, 16), (16, 3),
    (5, 17), (17, 18), (18, 19), (19, 4),
    (5, 20),
)
# Per-bone gray level: one band per finger so the digits are visually
# distinguishable in a mono image.
_BONE_GRAY = (
    150, 150, 150,
    170, 170, 170, 170,
    190, 190, 190, 190,
    210, 210, 210, 210,
    230, 230, 230, 230,
    140,
)
# Approximate anatomical stroke widths (mm) per bone, indexed like _BONES.
_BONE_WIDTH_MM = (
    22.0, 18.0, 15.0,
    17.0, 15.0, 13.0, 11.0,
    18.0, 16.0, 14.0, 12.0,
    17.0, 15.0, 13.0, 11.0,
    14.0, 12.0, 11.0, 10.0,
    30.0,
)


def _project_fisheye_np(v_eye: np.ndarray, cam_js: dict) -> np.ndarray:
    """[..., 3] eye points -> [..., 2] pixels; numpy mirror of
    geometry/cameras.py arctan_project + fisheye62_distort."""
    x, y, z = v_eye[..., 0], v_eye[..., 1], v_eye[..., 2]
    r = np.sqrt(x * x + y * y)
    s = np.arctan2(r, z) / np.maximum(r, 1e-18)
    p = np.stack([x * s, y * s], axis=-1)

    k = [cam_js[n] for n in ("k1", "k2", "k3", "k4")]
    p1, p2 = cam_js["p1"], cam_js["p2"]
    k5, k6 = cam_js["k5"], cam_js["k6"]
    r2 = np.clip(np.sum(p * p, axis=-1), 0.0, np.pi ** 2)
    radial = (
        1 + k[0] * r2 + k[1] * r2 ** 2 + k[2] * r2 ** 3 + k[3] * r2 ** 4
        + k5 * r2 ** 5 + k6 * r2 ** 6
    )
    uv = p * radial[..., None]
    ux, uy = uv[..., 0], uv[..., 1]
    r2t = ux * ux + uy * uy
    xd = ux + 2 * p2 * ux * uy + p1 * (r2t + 2 * ux * ux)
    yd = uy + 2 * p1 * ux * uy + p2 * (r2t + 2 * uy * uy)
    fx, fy, cx, cy = (cam_js[n] for n in ("fx", "fy", "cx", "cy"))
    return np.stack([xd * fx + cx, yd * fy + cy], axis=-1)


def tracker_gt_landmarks(hand_dict, angles, wrists) -> np.ndarray:
    """World landmarks [T, 2, 21, 3] (mm) with the tracker's right-hand
    convention: mirror the wrist x column, skin the left model."""
    wrists = np.asarray(wrists, np.float32).copy()  # [T, 2, 4, 4]
    wrists[:, 1, :, 0] *= -1.0  # right hand: mirror wrist x basis column
    return skin_landmarks(
        from_dict(hand_dict), torch.tensor(np.asarray(angles, np.float32)), torch.tensor(wrists)
    ).numpy()


def draw_hands_on_image(
    img: np.ndarray,  # [H, W] uint8, modified in place
    pix: np.ndarray,  # [n_hands, 21, 2] pixel coords
    in_front: np.ndarray,  # [n_hands, 21] bool (z > 0 in eye space)
    z_mm: np.ndarray,  # [n_hands, 21] eye-space depth (mm)
    px_per_mm: float,  # focal/z scale base (fx / 1 mm)
) -> None:
    """Draw hands as filled low-frequency shapes: a palm polygon plus thick
    finger strokes whose width is the anatomical width projected to pixels
    (w_mm * fx / z) and whose brightness falls off with depth.

    Hands are drawn in index order, so hand 1 occludes hand 0 where they
    overlap (a fixed, consistent z-order)."""
    import cv2

    h, w = img.shape
    for hand in range(pix.shape[0]):
        p = pix[hand]
        ok = (
            in_front[hand]
            & np.isfinite(p).all(axis=-1)
            & (np.abs(p) < 4 * max(h, w)).all(axis=-1)
        )

        def width_of(b, i, j):
            z = max(float(z_mm[hand, i] + z_mm[hand, j]) / 2, 50.0)
            return int(np.clip(round(_BONE_WIDTH_MM[b] * px_per_mm / z), 2, 25))

        def shade(base, i, j):
            # nearer = brighter: +-18% over the +-60 mm workspace depth range
            z = float(z_mm[hand, i] + z_mm[hand, j]) / 2
            return int(np.clip(base * (1.0 + (450.0 - z) / 330.0), 30, 255))

        def at(i):
            return (int(round(p[i, 0])), int(round(p[i, 1])))

        # palm: filled polygon over wrist + finger bases + palm center
        palm_ids = [5, 8, 11, 14, 17, 20]
        if all(ok[i] for i in palm_ids):
            hull = cv2.convexHull(np.asarray([at(i) for i in palm_ids], np.int32))
            cv2.fillConvexPoly(img, hull, shade(120, 5, 20), lineType=cv2.LINE_AA)

        for b, (i, j) in enumerate(_BONES):
            if ok[i] and ok[j]:
                cv2.line(
                    img, at(i), at(j), shade(_BONE_GRAY[b], i, j),
                    thickness=width_of(b, i, j), lineType=cv2.LINE_AA,
                )
        for l in range(21):
            if ok[l]:
                cv2.circle(
                    img, at(l), max(width_of(0, l, l) // 2 + 1, 2),
                    255 if l < 5 else shade(90 + 7 * l, l, l),
                    thickness=-1, lineType=cv2.LINE_AA,
                )


def render_fisheye_sequence(
    landmarks_world: np.ndarray,  # [T, 2, 21, 3] mm
    cam_poses: np.ndarray,  # [N, 4, 4] camera-to-world
    cam_jss,  # list of N camera JSON dicts
    rng,
    h: int = 480,
    w: int = 640,
    style: Optional[str] = None,
    radius_scale: float = 1.0,
    device=None,
) -> np.ndarray:  # [T, N, H, W] uint8
    """Render both hands into every fisheye view over a smooth-noise
    background.  ``style`` selects the renderer (DEFAULT_RENDER_STYLE); the
    capsule tracer runs on ``device`` (CUDA unless "cpu")."""
    device = resolve_device(device)
    t = landmarks_world.shape[0]
    n = cam_poses.shape[0]
    style = style or DEFAULT_RENDER_STYLE
    if style not in ("capsule", "strokes"):
        raise ValueError(f"unknown render style {style!r}: use 'capsule' or 'strokes'")
    if style == "capsule":
        from .render import render_sequence

        bg = smooth_images(rng, t, n=n, h=h, w=w, lo=25, hi=95, device=device)
        return render_sequence(
            landmarks_world, cam_poses, cam_jss, bg, rng,
            radius_scale=radius_scale, device=device,
        )
    images = smooth_images(rng, t, n=n, h=h, w=w, lo=25, hi=95, device="cpu").numpy()
    world_to_cam = np.stack([np.linalg.inv(p) for p in cam_poses])
    for ti in range(t):
        for c in range(n):
            r = world_to_cam[c, :3, :3]
            tr = world_to_cam[c, :3, 3]
            v_eye = landmarks_world[ti] @ r.T + tr  # [2, 21, 3]
            pix = _project_fisheye_np(v_eye, cam_jss[c])
            draw_hands_on_image(
                images[ti, c], pix, v_eye[..., 2] > 1.0,
                z_mm=v_eye[..., 2], px_per_mm=float(cam_jss[c]["fx"]),
            )
    return images


def make_labels_dict(
    t,
    rng_seed=0,
    with_dropout=True,
    mode: str = "separate",
    hand_scale: Optional[float] = None,
    render: bool = True,
    render_style: Optional[str] = None,
    device=None,
):
    """Full label dict in the raw_data JSON schema + images [T, N, H, W]
    uint8 (numpy).

    ``render=True`` draws the GT hands into the fisheye views (pose is then
    inferable from pixels); ``mode="hand_hand"`` generates interacting,
    occluding hands; ``hand_scale`` scales the GT user skeleton relative to
    the generic model (what the unknown-skeleton protocol must recover);
    ``render_style`` selects the renderer (default DEFAULT_RENDER_STYLE);
    the noise and the capsule tracer are computed on ``device`` (CUDA unless
    "cpu").
    """
    device = resolve_device(device)
    rng = np.random.default_rng(rng_seed)
    hand_dict = load_generic_hand_dict()
    if hand_scale is not None:
        hand_dict = scaled_hand_dict(hand_dict, hand_scale)

    cam_poses = make_camera_poses()
    angles, wrists, conf = make_gt_motion(rng, t, hand_dict, mode=mode)
    if not with_dropout:
        conf[:] = 1.0
    if render:
        images = render_fisheye_sequence(
            tracker_gt_landmarks(hand_dict, angles, wrists), cam_poses,
            [dict(CAM_JS) for _ in range(N_CAMS)], rng, style=render_style,
            radius_scale=hand_scale if hand_scale is not None else 1.0, device=device,
        )
    else:
        images = smooth_images(rng, t, device=device).cpu().numpy()

    labels = {
        "cameras": [dict(CAM_JS) for _ in range(N_CAMS)],
        "camera_angles": list(CAMERA_ANGLES),
        "camera_to_world_transforms": np.tile(cam_poses, (t, 1, 1, 1)).tolist(),
        "joint_angles": angles.tolist(),
        "wrist_transforms": wrists.tolist(),
        "hand_confidences": conf.tolist(),
        "hand_model": hand_dict,
    }
    return labels, images


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


def make_torchdata_sample(rng_seed=0, t=3, v=2, h=120, w=160, hand_idx=1, hand_scale=None,
                          render: bool = False, device=None):
    """A synthetic raw torch_data sample ``(mono [T, V, H, W] uint8, labels)``
    in the msgpack label schema: pinhole views aimed at the hand near the
    origin, mm units, GT motion from :func:`make_gt_motion`, and
    ``enclosing_points`` = the 63 crop points (GT + neutral + open pose
    landmarks).

    ``render=True`` is the JAX package's sample: its random numbers are
    drawn in the JAX package's order (the motion, a per-sequence focal
    length U(170, 235) and stroke thickness, the ``solved_joint_angles``
    noise, the smooth background, then the capsule render), so both
    packages give the same labels for one seed, and the capsule ray tracer
    draws the hand into both views on ``device`` (CUDA unless "cpu").
    ``render=False`` (the default) is the port's own: smooth-noise frames
    on the CPU and a focal length that grows with the frame width, so the
    hand fills the same share of any size (the JAX package's unrendered
    sample needs OpenCV)."""
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

    if render:
        focal = float(rng.uniform(170.0, 235.0))
        rng.integers(2, 5)  # the JAX package's stroke thickness: drawn to keep its order
    else:
        focal = 1.25 * w
    intr = np.tile(np.eye(3, dtype=np.float32), (t, v, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = focal
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
    if render:
        from .render import render_pinhole_sequence

        device = resolve_device(device)
        mono = render_pinhole_sequence(
            enclosing[:, None, :21], cam_poses, intr[0],
            smooth_images(rng, t, n=v, h=h, w=w, lo=25, hi=95, device=device), rng,
            radius_scale=1.0 if hand_scale is None else hand_scale, device=device,
        )
    else:
        mono = smooth_images(rng, t, n=v, h=h, w=w, device="cpu").numpy()

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
    root: str, n_train: int = 64, n_test: int = 8, t: int = 16, v: int = 2,
    h: int = 120, w: int = 160, seed0: int = 0, render: bool = True, device=None,
) -> dict:
    """Write a synthetic torch_data corpus to disk (``training`` and
    ``testing`` folders under ``root/synthetic/``, one idx/bin item per
    sequence), alternating hands and varying the GT hand scale per
    sequence; the hands are rendered on ``device`` (CUDA unless "cpu")
    unless ``render=False``, as the JAX package renders its corpus.
    Returns {split name: folder}."""
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
                hand_idx=i % 2, hand_scale=scale, render=render, device=device,
            )
            monos.append(mono)
            labels_list.append(labels)
        folder = os.path.join(root, "synthetic", split)
        write_idxbin(os.path.join(folder, "mono"), monos)
        write_idxbin(os.path.join(folder, "labels"), labels_list, msgpack_objects=True)
        out[split] = folder
    return out
