"""The benchmark's one traffic generator: rendered multi-view hand sequences.

A copy of the port's synthetic-sequence code (``utils/synthetic.py``: the
four-camera fisheye rig, the GT motion, the smooth-noise background) with
the capsule renderer of :mod:`portbench.render`.  A cell's traffic file
gives the parameters (how many sequences, how long, which motion modes,
the hand-scale range, the confidence drop-out); everything random is drawn
from the run's ``--seed``, one ``np.random.Generator`` per sequence, so a
seed always gives the same frames and every seed the same sizes.

A :class:`Recording` holds plain tensors, sequence-major: the rig
``[S, N]``, the frames ``[S, L, ...]`` (images uint8 on the device) and the
hand models ``[S, ...]``.  Each side (the program, the reference) wraps the
same tensors in its own dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from .reference.kinematics.hand import from_dict, load_generic_hand_dict
from .reference.kinematics.skinning import skin_landmarks
from .render import render_sequence

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
COEFF_NAMES = ("k1", "k2", "k3", "k4", "p1", "p2", "k5", "k6")
N_CAMS = 4
CAMERA_ANGLES = (0.0, 0.0, 180.0, 180.0)
CAM_POSITIONS = np.array(
    [
        [-120.0, -60.0, -430.0],
        [120.0, -60.0, -430.0],
        [-150.0, 80.0, -410.0],
        [150.0, 80.0, -410.0],
    ]
)
RIG_FIELDS = ("fx", "fy", "cx", "cy", "width", "height", "coeffs", "camera_angles")
FRAME_FIELDS = ("images", "T_world_from_camera", "gt_joint_angles", "gt_wrist_xfs", "gt_confidences")
HAND_FIELDS = ("joint_rotation_axes", "joint_rest_positions", "landmark_rest_positions",
               "landmark_rest_bone_weights", "landmark_rest_bone_indices", "joint_limits",
               "hand_scale")


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


def make_camera_poses():
    """Four cameras ~450 mm out, looking at the origin (mm)."""
    return np.stack([look_at_pose(p, np.zeros(3)) for p in CAM_POSITIONS]).astype(np.float32)


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


def smooth_images(rng, t, n, h, w, lo, hi, device):
    """Smooth noise images, uint8 [T, N, H, W] on ``device``: a 15 x 20 grid
    of uniform values per image, upsampled bicubically."""
    base = rng.uniform(lo, hi, size=(t * n, 1, 15, 20)).astype(np.float32)
    img = F.interpolate(torch.from_numpy(base).to(device), size=(h, w), mode="bicubic",
                        align_corners=False)
    return img.clamp(0, 255).to(torch.uint8).reshape(t, n, h, w)


def tracker_gt_landmarks(hand_dict, angles, wrists) -> np.ndarray:
    """World landmarks [T, 2, 21, 3] (mm) with the tracker's right-hand
    convention: mirror the wrist x column, skin the left model."""
    wrists = np.asarray(wrists, np.float32).copy()
    wrists[:, 1, :, 0] *= -1.0
    return skin_landmarks(
        from_dict(hand_dict), torch.tensor(np.asarray(angles, np.float32)), torch.tensor(wrists)
    ).numpy()


def scaled_hand_dict(hand_dict: dict, scale: float) -> dict:
    """Uniformly scale a hand-model dict's rest geometry."""
    out = dict(hand_dict)
    for key in ("joint_rest_positions", "landmark_rest_positions"):
        out[key] = (np.asarray(hand_dict[key], np.float32) * scale).tolist()
    base = hand_dict.get("hand_scale")
    out["hand_scale"] = float(base if base is not None else 1.0) * scale
    return out


@dataclasses.dataclass
class Recording:
    """S rendered sequences of L frames as plain tensors (see the module's
    docstring); ``scales`` [S] are the GT hand scales against the generic
    hand."""

    rig: Dict[str, torch.Tensor]
    frames: Dict[str, torch.Tensor]
    hand: Dict[str, torch.Tensor]
    scales: torch.Tensor

    @property
    def n_sequences(self) -> int:
        return self.scales.shape[0]

    @property
    def n_frames(self) -> int:
        return self.frames["images"].shape[1]


def sequence_rng(seed: int, index: int) -> np.random.Generator:
    """The generator of sequence ``index`` of a run seeded ``seed`` (any
    non-negative integer, of any size)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(index)]))


def check_rng(seed: int) -> np.random.Generator:
    """The generator that draws which answers a run compares: a stream of
    its own, apart from every sequence's."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), 1 << 40]))


def render_recording(seed: int, n_sequences: int, n_frames: int, modes: Sequence[str],
                     hand_scale: Sequence[float], dropout: bool, device) -> Recording:
    """``n_sequences`` sequences of ``n_frames`` rendered frames each:
    sequence ``i`` moves in ``modes[i % len(modes)]`` with a GT hand scaled
    by U[``hand_scale``] against the generic hand, and (with ``dropout``)
    loses hand 1's confidence for 3 frames a third of the way in."""
    generic = load_generic_hand_dict()
    cam_poses = make_camera_poses()
    images, angles, wrists, confs, hands, scales = [], [], [], [], [], []
    for i in range(n_sequences):
        rng = sequence_rng(seed, i)
        scale = float(rng.uniform(*hand_scale))
        hand_dict = scaled_hand_dict(generic, scale)
        a, w, c = make_gt_motion(rng, n_frames, hand_dict, mode=modes[i % len(modes)])
        if not dropout:
            c[:] = 1.0
        bg = smooth_images(rng, n_frames, N_CAMS, CAM_JS["ImageSizeY"], CAM_JS["ImageSizeX"],
                           25, 95, device)
        images.append(render_sequence(tracker_gt_landmarks(hand_dict, a, w), cam_poses,
                                      [CAM_JS] * N_CAMS, bg, rng, radius_scale=scale, device=device))
        angles.append(a)
        wrists.append(w)
        confs.append(c)
        hands.append(from_dict(hand_dict))
        scales.append(scale)

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype).to(device)

    s = n_sequences
    cams = [CAM_JS] * N_CAMS
    rig = dict(
        fx=[c["fx"] for c in cams], fy=[c["fy"] for c in cams], cx=[c["cx"] for c in cams],
        cy=[c["cy"] for c in cams], width=[c["ImageSizeX"] for c in cams],
        height=[c["ImageSizeY"] for c in cams],
        coeffs=[[c[n] for n in COEFF_NAMES] for c in cams], camera_angles=list(CAMERA_ANGLES),
    )
    rig = {k: dev(np.broadcast_to(np.asarray(v, np.float32), (s, *np.shape(v)))) for k, v in rig.items()}
    frames = dict(
        images=torch.stack(images),
        T_world_from_camera=dev(np.broadcast_to(cam_poses, (s, n_frames, *cam_poses.shape))),
        gt_joint_angles=dev(np.stack(angles)),
        gt_wrist_xfs=dev(np.stack(wrists)),
        gt_confidences=dev(np.stack(confs)),
    )
    hand = {}
    for name in HAND_FIELDS:
        leaves = [getattr(h, name) for h in hands]
        hand[name] = None if leaves[0] is None else torch.stack(leaves).to(device)
    return Recording(rig=rig, frames=frames, hand=hand, scales=dev(scales))


def generic_hand(device) -> Dict[str, torch.Tensor]:
    """The generic hand's fields (unbatched)."""
    h = from_dict(load_generic_hand_dict(), device=device)
    return {name: getattr(h, name) for name in HAND_FIELDS}


def call_frames(call: Sequence[int], frames_per_call: int) -> torch.Tensor:
    """The frame indices of one call of a cell's cycle: ``[start, step]``
    gives ``start, start + step, ...`` (a rendered sequence played forward
    or backward)."""
    start, step = call
    return torch.arange(frames_per_call) * step + start


def pingpong(n_frames: int) -> list:
    """Frame indices of a sequence played forward and back, with no repeat
    at either end: 0, 1, ..., L-1, L-2, ..., 1 (then 0 again)."""
    return list(range(n_frames)) + list(range(n_frames - 2, 0, -1))
