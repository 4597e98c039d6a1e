from .tracker import calibrate_sequences_batched, track_frame, track_sequences_batched
from .types import CameraRig, FrameObservation, FrameResult, TrackerConfig, TrackState

__all__ = [
    "calibrate_sequences_batched",
    "track_frame",
    "track_sequences_batched",
    "CameraRig",
    "FrameObservation",
    "FrameResult",
    "TrackerConfig",
    "TrackState",
]
