"""Host-side video + label loading for raw_data sequences.

Counterpart of ``umetrack_tpu/tracker/video.py``: an ``X.mp4`` holding a
horizontally-concatenated N-camera mono strip paired with an ``X.json``
holding cameras, per-frame camera poses, GT joint angles / wrist transforms
/ confidences and the per-user hand model.  Decode uses OpenCV, imported
inside :func:`stream_video_strip` only; arrays stay numpy on the host (the
rig and the hand model are small CPU tensors) until the eval code ships a
sequence or a chunk to the device in one transfer.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from ..kinematics.hand import HandModel, from_dict as hand_from_dict
from .types import CameraRig

_COEFF_NAMES = ("k1", "k2", "k3", "k4", "p1", "p2", "k5", "k6")


@dataclasses.dataclass
class SequenceData:
    """A fully-loaded raw_data sequence (host numpy)."""

    images: np.ndarray  # [T, N, H, W] uint8
    T_world_from_camera: np.ndarray  # [T, N, 4, 4]
    gt_joint_angles: np.ndarray  # [T, 2, 22]
    gt_wrist_xfs: np.ndarray  # [T, 2, 4, 4] (mm)
    gt_confidences: np.ndarray  # [T, 2]
    rig: CameraRig
    hand_model_mm: HandModel
    n_frames: int


def load_labels(label_path: str):
    with open(label_path, "r") as fp:
        return json.load(fp)


def rig_from_labels(labels: dict, device="cpu") -> CameraRig:
    """The N-camera fisheye rig from the label JSON's camera blocks."""
    cams = [c.get("Camera", c) for c in labels["cameras"]]

    def field(values):
        return torch.tensor(values, dtype=torch.float32, device=device)

    return CameraRig(
        fx=field([c["fx"] for c in cams]),
        fy=field([c["fy"] for c in cams]),
        cx=field([c["cx"] for c in cams]),
        cy=field([c["cy"] for c in cams]),
        width=field([c["ImageSizeX"] for c in cams]),
        height=field([c["ImageSizeY"] for c in cams]),
        coeffs=field([[c.get(n, 0.0) for n in _COEFF_NAMES] for c in cams]),
        camera_angles=field(labels["camera_angles"]),
    )


def stream_video_strip(video_path: str, n_cameras: int, chunk_size: int):
    """Decode an N-camera strip mp4 in bounded-memory chunks.

    Generator of ``[C, N, H, W]`` uint8 blocks (C <= chunk_size); the host
    never holds more than one chunk, and each device submission still
    batches C frames.
    """
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video: {video_path}")
    buf: List[np.ndarray] = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            mono = frame[..., 0]
            h, total_w = mono.shape
            buf.append(
                np.moveaxis(
                    mono.reshape(h, n_cameras, total_w // n_cameras), 1, 0
                )
            )
            if len(buf) == chunk_size:
                yield np.stack(buf)
                buf = []
        if buf:
            yield np.stack(buf)
    finally:
        cap.release()


def decode_video_strip(video_path: str, n_cameras: int) -> np.ndarray:
    """Decode a whole N-camera mono strip mp4 -> [T, N, H, W] uint8."""
    return np.concatenate(list(stream_video_strip(video_path, n_cameras, 64)))


@dataclasses.dataclass
class SequenceStream:
    """Bounded-memory raw_data sequence: labels fully loaded (small), video
    decoded lazily in chunks via :meth:`chunks`.

    ``images`` may hold an in-memory [T, N, H, W] source instead of a video
    file (synthetic data, tests); the bounded-memory property then applies
    to the device side only.
    """

    video_path: Optional[str]
    T_world_from_camera: np.ndarray  # [T, N, 4, 4]
    gt_joint_angles: np.ndarray  # [T, 2, 22]
    gt_wrist_xfs: np.ndarray  # [T, 2, 4, 4] (mm)
    gt_confidences: np.ndarray  # [T, 2]
    rig: CameraRig
    hand_model_mm: HandModel
    n_frames: int
    images: Optional[np.ndarray] = None

    def chunks(self, chunk_size: int):
        """Yield ``(t0, images[C, N, H, W])`` blocks, C <= chunk_size."""
        if self.images is not None:
            for t0 in range(0, self.n_frames, chunk_size):
                yield t0, self.images[t0:t0 + chunk_size]
            return
        n_cameras = int(self.rig.num_cameras)
        t0 = 0
        for images in stream_video_strip(
            self.video_path, n_cameras, chunk_size
        ):
            yield t0, images
            t0 += len(images)
        if t0 != self.n_frames:
            raise ValueError(f"video frames ({t0}) != label frames ({self.n_frames})")


def stream_from_data(seq: SequenceData) -> SequenceStream:
    """Wrap an in-memory SequenceData as a stream (synthetic data, tests)."""
    return SequenceStream(
        video_path=None,
        T_world_from_camera=seq.T_world_from_camera,
        gt_joint_angles=seq.gt_joint_angles,
        gt_wrist_xfs=seq.gt_wrist_xfs,
        gt_confidences=seq.gt_confidences,
        rig=seq.rig,
        hand_model_mm=seq.hand_model_mm,
        n_frames=seq.n_frames,
        images=seq.images,
    )


def _label_arrays(label_path: str) -> dict:
    """The label JSON as the fields both sequence forms share.  Frames whose
    cameras were not tracked have all-zero poses and no GT: they get identity
    poses and zero confidence, so the device pipeline stays finite."""
    labels = load_labels(label_path)
    joint_angles = np.asarray(labels["joint_angles"], np.float32)
    conf = np.asarray(labels["hand_confidences"], np.float32)
    cam_poses = np.asarray(labels["camera_to_world_transforms"], np.float32)
    n = len(joint_angles)
    invalid = cam_poses.reshape(n, -1).sum(axis=-1) == 0
    cam_poses[invalid] = np.eye(4, dtype=np.float32)
    conf[invalid] = 0.0
    return dict(
        T_world_from_camera=cam_poses,
        gt_joint_angles=joint_angles,
        gt_wrist_xfs=np.asarray(labels["wrist_transforms"], np.float32),
        gt_confidences=conf,
        rig=rig_from_labels(labels),
        hand_model_mm=hand_from_dict(labels["hand_model"]),
        n_frames=n,
    )


def open_sequence(video_path: str, label_path: Optional[str] = None) -> SequenceStream:
    """Open a raw_data sequence for streaming: parse labels (small) but defer
    video decode to :meth:`SequenceStream.chunks`."""
    fields = _label_arrays(label_path or video_path[:-4] + ".json")
    return SequenceStream(video_path=video_path, **fields)


def load_sequence(video_path: str, label_path: Optional[str] = None) -> SequenceData:
    """Load one raw_data sequence: mp4 strip + JSON labels."""
    fields = _label_arrays(label_path or video_path[:-4] + ".json")
    images = decode_video_strip(video_path, int(fields["rig"].num_cameras))
    if len(images) != fields["n_frames"]:
        raise ValueError(f"video frames ({len(images)}) != label frames ({fields['n_frames']})")
    return SequenceData(images=images, **fields)
