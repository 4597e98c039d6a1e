"""Evaluation metrics (numpy on the host).

The port's own copy of ``umetrack_tpu/metrics.py``: PCK curve over 0-50 mm,
normalized AUC, per-frame mean keypoint error (MPJPE), 2nd-difference
keypoint acceleration, tracked-frame success rate, and MPJPA (mean
per-joint angular error), which the original project reports but whose
released scripts never compute.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

MAX_LANDMARK_ERROR_MM = 50
PCK_THRESHOLDS = np.linspace(0, MAX_LANDMARK_ERROR_MM, 101)


def _safe_div(x, y, eps: float = 1e-6, default_val: float = 0.0):
    if np.isscalar(x):
        return default_val if y < eps else x / y
    z = np.divide(x, np.maximum(y, eps))
    z = np.where(y < eps, default_val, z)
    return z


def PCK_curve(
    errors: np.ndarray,
    thresholds: np.ndarray,
    mask: Optional[np.ndarray] = None,
    axis: Optional[int] = None,
) -> np.ndarray:
    """Fraction of errors under each threshold; optionally one curve per
    element along ``axis``."""
    if mask is None:
        mask = np.ones_like(errors)
    if axis is None:
        err = errors.reshape(1, -1)
        msk = mask.reshape(1, -1)
    else:
        n = errors.shape[axis]
        err = np.moveaxis(errors, axis, 0).reshape(n, -1)
        msk = np.moveaxis(mask, axis, 0).reshape(n, -1)

    below = err[None, :, :] <= thresholds[:, None, None]  # [T, N, M]
    num = (below * msk[None]).sum(axis=-1)
    den = msk.sum(axis=-1)[None]
    pck = _safe_div(num, den).T  # [N, T]
    return pck[0] if axis is None else pck


def normalized_AUC(x: np.ndarray, y: np.ndarray, y_max: float = 1.0) -> np.ndarray:
    """Trapezoidal area under curves sharing x, normalized to [0, 1]."""
    out_shape = y.shape[:-1]
    yy = y.reshape(-1, y.shape[-1])
    auc = ((x[1:] - x[:-1])[None, :] * 0.5 * (yy[:, 1:] + yy[:, :-1])).sum(axis=-1)
    max_area = (x[-1] - x[0]) * y_max
    return (auc / max_area).reshape(out_shape)


# The MPJPA caveat: ONE string, attached to every surface that prints or
# tabulates MPJPA next to the original project's published numbers.
MPJPA_CAVEAT = (
    "MPJPA here is OUR reconstruction (mean |angle delta| over the 20 "
    "actuated DoF); the reference quotes eq. 10 of the paper but ships no "
    "implementation, so the two MPJPA columns are not directly comparable."
)


@dataclasses.dataclass
class SequenceMetrics:
    keypoint_errors: np.ndarray  # [n_valid_frames]
    keypoint_accelerations: np.ndarray
    gt_keypoint_accelerations: np.ndarray
    angle_errors_deg: np.ndarray  # [n_valid_frames] MPJPA contributions


def compute_sequence_metrics(
    gt_keypoints: np.ndarray,  # [n_hands, T, 21, 3]
    tracked_keypoints: np.ndarray,
    valid_tracking: np.ndarray,  # [n_hands, T] bool
    gt_joint_angles: Optional[np.ndarray] = None,  # [n_hands, T, 22]
    tracked_joint_angles: Optional[np.ndarray] = None,
) -> SequenceMetrics:
    """Per-sequence metric arrays."""

    def accel(pts):
        a = pts[:, 0:-2] + pts[:, 2:] - 2 * pts[:, 1:-1]
        return np.linalg.norm(a, axis=-1).mean(axis=-1)

    diff = gt_keypoints - tracked_keypoints
    keypoint_errors = np.linalg.norm(diff, axis=-1).mean(axis=-1)
    valid_acc = (
        valid_tracking[:, 0:-2] & valid_tracking[:, 1:-1] & valid_tracking[:, 2:]
    )
    if gt_joint_angles is not None and tracked_joint_angles is not None:
        # MPJPA — OUR definition: mean absolute per-joint angle difference,
        # degrees, over the 20 actuated finger DoF (the 2 appended wrist
        # angles are always zero in both GT labels and predictions).
        # The original project quotes "MPJPA (deg), eq. 10 of the paper"
        # but never implements it: this is a plausible reconstruction, NOT
        # a parity-tested formula (see MPJPA_CAVEAT).
        ang = np.abs(gt_joint_angles[..., :20] - tracked_joint_angles[..., :20])
        angle_errors = np.degrees(ang.mean(axis=-1))[valid_tracking]
    else:
        angle_errors = np.zeros(0)

    return SequenceMetrics(
        keypoint_errors=keypoint_errors[valid_tracking],
        keypoint_accelerations=accel(tracked_keypoints)[valid_acc],
        gt_keypoint_accelerations=accel(gt_keypoints)[valid_acc],
        angle_errors_deg=angle_errors,
    )


def aggregate(metrics_list, valid_tracking_list) -> Dict[str, float]:
    """Combine per-sequence metrics into the summary dict that ``load_eval``
    prints."""
    if not metrics_list:
        return {}
    errors = np.concatenate([m.keypoint_errors for m in metrics_list])
    accs = np.concatenate([m.keypoint_accelerations for m in metrics_list])
    gt_accs = np.concatenate([m.gt_keypoint_accelerations for m in metrics_list])
    angles = np.concatenate([m.angle_errors_deg for m in metrics_list])
    valid = np.concatenate(valid_tracking_list, axis=1)

    # pck_auc is normalized to [0, 1]; the original project prints the same
    # quantity x100.
    pck = PCK_curve(errors, PCK_THRESHOLDS) * 100.0
    out = {
        "n_total_frames": int(valid.size),
        "n_tracked_frames": int(valid.sum()),
        "success_rate": float(valid.sum() / max(valid.size, 1)),
        "mpjpe_mm": float(errors.mean()) if errors.size else float("nan"),
        "pck_auc": float(normalized_AUC(PCK_THRESHOLDS, pck, y_max=100.0)),
        "mean_keypoint_acceleration": float(accs.mean()) if accs.size else float("nan"),
        "gt_mean_keypoint_acceleration": float(gt_accs.mean()) if gt_accs.size else float("nan"),
    }
    if angles.size:
        out["mpjpa_deg"] = float(angles.mean())
        out["mpjpa_caveat"] = MPJPA_CAVEAT
    return out
