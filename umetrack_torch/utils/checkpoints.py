"""Checkpoint save/load for the port's model.

Counterpart of ``umetrack_tpu/utils/checkpoints.py`` and of
``models/convert.py::load_torch_checkpoint`` there.  A ``.msgpack`` file is
a flax state dict (``{"params", "batch_stats"}`` with array leaves), read
and written with the port's own codec (``data/_msgpack.py``) and carried to
and from the port's state dict by ``models/convert.py``; a ``.torch`` file
is a state dict of the original UmeTrack torch model.  A directory is the
JAX package's orbax format, which the port does not read.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import torch

from ..data import _msgpack
from ..models.config import ModelConfig
from ..models.convert import (
    from_flax_variables,
    from_reference_state_dict,
    to_flax_variables,
)


def load_checkpoint(path: str, config: Optional[ModelConfig] = None) -> Dict[str, torch.Tensor]:
    """A state dict for ``UmeTrackNet(config)`` from a ``.msgpack`` (flax)
    or ``.torch`` (original model) file, with names and shapes checked
    against ``config`` (default ``ModelConfig()``)."""
    config = config or ModelConfig()
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory, i.e. an orbax checkpoint: the orbax format is "
            "not ported; save it as a .msgpack file with the JAX package first"
        )
    if path.endswith(".msgpack"):
        with open(path, "rb") as fp:
            variables = _msgpack.unpackb(fp.read())
        if not isinstance(variables, dict) or "params" not in variables:
            raise ValueError(f"{path} holds no flax variables (no 'params' entry)")
        return from_flax_variables(variables, config)
    if path.endswith(".torch"):
        with open(path, "rb") as fp:
            sd = torch.load(fp, map_location="cpu", weights_only=True)
        return from_reference_state_dict(sd, config)
    raise ValueError(f"unknown checkpoint format {path!r}: use a .msgpack or .torch file")


def save_checkpoint(path: str, state_dict) -> str:
    """Write a port state dict as a flax ``.msgpack`` file, byte for byte
    what ``flax.serialization.to_bytes`` writes for the same variables.
    The bytes go to a temporary file in the target's folder, which then
    replaces the target in one step: a run killed mid-write leaves the
    previous checkpoint whole and no partial file behind."""
    if not path.endswith(".msgpack"):
        raise NotImplementedError(f"{path!r}: only the .msgpack format is ported")
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    data = _msgpack.packb(to_flax_variables(state_dict))
    fd, tmp = tempfile.mkstemp(prefix=".tmp_", suffix=".msgpack", dir=folder)
    try:
        with os.fdopen(fd, "wb") as fp:
            fp.write(data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path
