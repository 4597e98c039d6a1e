"""Label loading for raw_data sequences (the camera rig only).

Counterpart of ``rig_from_labels`` in ``umetrack_tpu/tracker/video.py``;
video decoding is not ported yet.
"""
from __future__ import annotations

import torch

from .types import CameraRig

_COEFF_NAMES = ("k1", "k2", "k3", "k4", "p1", "p2", "k5", "k6")


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
