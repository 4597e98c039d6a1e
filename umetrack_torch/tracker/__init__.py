from .crops import gen_crop_set, gen_crops_for_hand, landmarks_from_pose, static_crop_points_local
from .tracker import (
    HandTracker,
    calibrate_sequence,
    calibrate_sequences_batched,
    predict_scales_sequence,
    sequence_landmarks,
    track_frame,
    track_sequence,
    track_sequences_batched,
)
from .types import (
    CameraRig,
    CropSet,
    FrameObservation,
    FrameResult,
    TrackerConfig,
    TrackState,
)
from .video import rig_from_labels

__all__ = [
    "gen_crop_set",
    "gen_crops_for_hand",
    "landmarks_from_pose",
    "static_crop_points_local",
    "HandTracker",
    "calibrate_sequence",
    "calibrate_sequences_batched",
    "predict_scales_sequence",
    "sequence_landmarks",
    "track_frame",
    "track_sequence",
    "track_sequences_batched",
    "CameraRig",
    "CropSet",
    "FrameObservation",
    "FrameResult",
    "TrackerConfig",
    "TrackState",
    "rig_from_labels",
]
