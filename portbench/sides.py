"""The two sides of every comparison, built from the same plain tensors.

``side("umetrack_torch")`` is the program under test; ``side(REFERENCE)``
is the benchmark's frozen plain reference (:mod:`portbench.reference`).
Both packages lay out their tracker, kinematics and model alike, so one
:class:`Side` wraps either: it builds that package's dataclasses from a
:class:`~portbench.traffic.Recording`'s tensors and its model from a
configuration file and a state dict.  The program is imported only when
its side is asked for.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

import torch

from .traffic import FRAME_FIELDS, HAND_FIELDS, RIG_FIELDS, Recording

PROGRAM = "umetrack_torch"
REFERENCE = "portbench.reference"


@dataclasses.dataclass
class Side:
    """One package's tracker, kinematics and model."""

    package: str
    tracker: object
    hand: object
    models: object

    def rig(self, rec: Recording, rows=slice(None)):
        return self.tracker.CameraRig(**{k: rec.rig[k][rows] for k in RIG_FIELDS})

    def frames(self, rec: Recording, rows, frames) -> object:
        """``FrameObservation`` of sequences ``rows`` at frame indices
        ``frames`` (a 1-D index tensor, or an int for one frame)."""
        return self.tracker.FrameObservation(**{
            k: rec.frames[k][rows][:, frames] if isinstance(rows, slice) and not isinstance(frames, int)
            else rec.frames[k][rows, frames] for k in FRAME_FIELDS})

    def hand_model(self, fields: Dict[str, Optional[torch.Tensor]], rows=None):
        return self.hand.HandModel(**{
            k: None if fields[k] is None else (fields[k] if rows is None else fields[k][rows])
            for k in HAND_FIELDS})

    def model_config(self, config: dict, compute_dtype: Optional[str] = None):
        widths = {k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items()}
        if compute_dtype is not None:
            widths["compute_dtype"] = compute_dtype
        return self.models.ModelConfig(**widths)

    def model(self, config: dict, state_dict: Dict[str, torch.Tensor], device,
              compute_dtype: Optional[str] = None):
        """The model of ``config`` with ``state_dict`` loaded, on ``device``,
        in eval mode."""
        model = self.models.UmeTrackNet(self.model_config(config, compute_dtype)).to(device)
        model.load_state_dict(state_dict)
        return model.eval()

    def tracker_config(self, config: dict):
        fields = {k: tuple(v) if isinstance(v, list) else v for k, v in config["tracker"].items()}
        return self.tracker.TrackerConfig(**fields)

    def zero_state(self, model, rows: int, device):
        return self.tracker.TrackState.init(model.config, rows, device=device)

    def state(self, tree):
        """Another side's ``TrackState`` as this side's (the same tensors)."""
        temporal = self.models.TemporalState(
            mem_features=tree.temporal.mem_features, prev_extrinsics=tree.temporal.prev_extrinsics)
        return self.tracker.TrackState(temporal=temporal, valid_history=tree.valid_history)


def side(package: str) -> Side:
    return Side(
        package=package,
        tracker=importlib.import_module(f"{package}.tracker"),
        hand=importlib.import_module(f"{package}.kinematics.hand"),
        models=importlib.import_module(f"{package}.models"),
    )
