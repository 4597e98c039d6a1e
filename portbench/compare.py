"""What decides ``correct``: the numbers compared with the reference, each
against its limit from the cell's file.

The tracking numbers are widest gaps between what the program returned and
what the reference computes on the same inputs from the same state:

- ``angle_gap_rad``: joint angles, over the hand slots the reference calls
  valid;
- ``wrist_gap_mm``: wrist translations (mm), over the same slots;
- ``wrist_median_gap_mm``, ``wrist_rot_gap``, ``wrist_rot_median_gap``:
  the median over those slots of each slot's widest translation gap, the
  widest gap of the rotations' entries, and its median over the slots: the
  wrist decode's rounding is magnified in a few ill-conditioned slots,
  which can set a widest gap whatever the precision, while the typical
  slot follows the precision;
- ``state_gap``: the carried state's float leaves (the conv-RNN memory and
  the previous crop-camera extrinsics), every row; ``state_rel_gap``: the
  L2 norm of the memory's difference over the reference memory's norm;
- ``flag_mismatches``: entries of ``valid``, ``n_views`` and the carried
  ``valid_history`` that differ (an exact comparison);
- ``scale_gap``: the calibrated skeleton scales, relative to the
  reference's (the unknown-skeleton protocol only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional

import torch


@dataclasses.dataclass
class Compared:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _max_abs(a: torch.Tensor, b: torch.Tensor, mask: Optional[torch.Tensor] = None) -> float:
    d = (a.double() - b.double()).abs()
    if mask is not None:
        d = d[mask]
    if d.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(d, nan=math.inf).max())


def _median_slot(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor) -> float:
    per_slot = (a.double() - b.double()).abs().flatten(-2).amax(-1)[valid]
    if per_slot.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(per_slot, nan=math.inf).median())


def tracking_gaps(got, want, got_state=None, want_state=None) -> Dict[str, float]:
    """The widest gaps between two tracker results (``FrameResult``-like:
    joint_angles, wrist_xfs, valid, n_views, predicted_scales) and, when
    given, their carried states."""
    valid = want.valid.bool()
    v = valid[..., None]
    gaps = {
        "angle_gap_rad": _max_abs(got.joint_angles, want.joint_angles, v.expand_as(want.joint_angles)),
        "wrist_gap_mm": _max_abs(got.wrist_xfs[..., :3, 3], want.wrist_xfs[..., :3, 3],
                                 v.expand_as(want.wrist_xfs[..., :3, 3])),
        "wrist_rot_gap": _max_abs(got.wrist_xfs[..., :3, :3], want.wrist_xfs[..., :3, :3],
                                  v[..., None].expand_as(want.wrist_xfs[..., :3, :3])),
        "wrist_median_gap_mm": _median_slot(got.wrist_xfs[..., :3, 3:], want.wrist_xfs[..., :3, 3:], valid),
        "wrist_rot_median_gap": _median_slot(got.wrist_xfs[..., :3, :3], want.wrist_xfs[..., :3, :3], valid),
        "flag_mismatches": float((got.valid.bool() != valid).sum() + (got.n_views != want.n_views).sum()),
    }
    if got_state is not None:
        gaps["state_gap"] = max(
            _max_abs(got_state.temporal.mem_features, want_state.temporal.mem_features),
            _max_abs(got_state.temporal.prev_extrinsics, want_state.temporal.prev_extrinsics))
        got_mem, want_mem = got_state.temporal.mem_features.double(), want_state.temporal.mem_features.double()
        gaps["state_rel_gap"] = float(torch.nan_to_num(
            (got_mem - want_mem).norm() / want_mem.norm().clamp(min=1e-30), nan=math.inf))
        gaps["flag_mismatches"] += float((got_state.valid_history.bool() != want_state.valid_history.bool()).sum())
    return gaps


def scale_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.nan_to_num(((got.double() - want.double()) / want.double()).abs(), nan=math.inf).max())


def widest(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def against_limits(values: Dict[str, float], limits: Dict[str, float]) -> List[Compared]:
    """The numbers the cell's file gives a limit, each with its limit (a
    reading with no limit is not compared: it separates no sound run from
    the control in that cell)."""
    missing = sorted(set(limits) - set(values))
    if missing:
        raise KeyError(f"limits for numbers the run does not give: {missing}")
    return [Compared(name, values[name], float(limits[name])) for name in sorted(limits)]
