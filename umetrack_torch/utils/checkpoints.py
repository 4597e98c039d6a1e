"""Checkpoint save/load for the port's model.

Counterpart of ``umetrack_tpu/utils/checkpoints.py`` and of
``models/convert.py::load_torch_checkpoint`` there.  A ``.msgpack`` file is
a flax state dict (``{"params", "batch_stats"}`` with array leaves), read
and written with the port's own codec (``data/_msgpack.py``) and carried to
and from the port's state dict by ``models/convert.py``; a ``.torch`` file
is a state dict of the original UmeTrack torch model.  Any other path is
the JAX package's orbax directory (``StandardCheckpointer``: OCDBT and
zarr v2), read and written by ``utils/orbax.py`` without orbax, the same
rule as the JAX package's (``.msgpack`` -> flax, anything else -> orbax).
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import torch

from ..data import _msgpack
from . import orbax
from ..models.config import ModelConfig
from ..models.convert import from_flax_variables, load_torch_checkpoint, to_flax_variables


def load_checkpoint(path: str, config: Optional[ModelConfig] = None) -> Dict[str, torch.Tensor]:
    """A state dict for ``UmeTrackNet(config)`` from a ``.msgpack`` (flax)
    file, a ``.torch`` (original model) file or an orbax checkpoint
    directory (any other path), with names and shapes checked against
    ``config`` (default ``ModelConfig()``)."""
    config = config or ModelConfig()
    if path.endswith(".msgpack"):
        with open(path, "rb") as fp:
            variables = _msgpack.unpackb(fp.read())
        if not isinstance(variables, dict) or "params" not in variables:
            raise ValueError(f"{path} holds no flax variables (no 'params' entry)")
        return from_flax_variables(variables, config)
    if path.endswith(".torch"):
        return load_torch_checkpoint(path, config)
    variables = orbax.read_standard_checkpoint(path)
    if "params" not in variables:
        raise ValueError(f"{path} holds no flax variables (no 'params' entry)")
    return from_flax_variables(variables, config)


def save_checkpoint(path: str, state_dict) -> str:
    """Write a port state dict as flax variables: a ``.msgpack`` path gets
    a flax file, byte for byte what ``flax.serialization.to_bytes`` writes
    for the same variables; any other path an orbax directory that the JAX
    package's ``load_checkpoint`` restores (``utils/orbax.py``), replacing
    an existing one.  Either is written beside the target first and then
    takes its place: a run killed mid-write leaves the previous checkpoint
    whole.  A ``.torch`` path is refused: that is the original model's
    format, which the port reads but does not write."""
    if path.endswith(".torch"):
        raise ValueError(f"{path!r}: the port writes .msgpack files or orbax directories, "
                         "not the original model's .torch state dicts")
    if not path.endswith(".msgpack"):
        return orbax.write_standard_checkpoint(path, to_flax_variables(state_dict))
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
