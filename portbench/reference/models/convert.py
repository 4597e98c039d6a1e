"""Flax variables -> the model's state dict: a plain walk over
``{"params", "batch_stats"}`` (conv kernels HWIO -> OIHW, Dense kernels
``(in, out)`` -> ``(out, in)``, BatchNorm ``scale``/``bias`` ->
``weight``/``bias``, ``mean``/``var`` -> ``running_mean``/``running_var``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .config import ModelConfig


def _walk(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _walk(value, path + ".")
        else:
            yield path, np.asarray(value)


def _param(path: str, leaf: str, a: np.ndarray, is_bn: bool) -> tuple:
    if leaf == "kernel":
        if a.ndim == 4:  # conv HWIO -> OIHW
            return f"{path}.weight", np.transpose(a, (3, 2, 0, 1))
        if a.ndim == 2:  # Dense (in, out) -> Linear (out, in)
            return f"{path}.weight", a.T
        raise ValueError(f"unexpected kernel rank {a.ndim} at {path}")
    if leaf == "scale" and is_bn:
        return f"{path}.weight", a
    if leaf == "bias":
        return f"{path}.bias", a
    raise ValueError(f"unexpected parameter {path}.{leaf}")


def from_flax_variables(
    variables_np: Mapping[str, Any], config: Optional[ModelConfig] = None
) -> Dict[str, torch.Tensor]:
    """Convert ``{"params": ..., "batch_stats": ...}`` (numpy leaves) into a
    state dict for :class:`~umetrack_torch.models.umetrack.UmeTrackNet`.
    With ``config`` given, the keys and shapes are checked against the
    port's model of that config."""
    stats_names = {"mean": "running_mean", "var": "running_var"}
    bn_modules = set()
    sd: Dict[str, np.ndarray] = {}
    for full, a in _walk(variables_np.get("batch_stats", {})):
        path, leaf = full.rsplit(".", 1)
        if leaf not in stats_names:
            raise ValueError(f"unexpected batch stat {full}")
        sd[f"{path}.{stats_names[leaf]}"] = a
        bn_modules.add(path)
    for full, a in _walk(variables_np["params"]):
        path, leaf = full.rsplit(".", 1)
        key, value = _param(path, leaf, a, path in bn_modules)
        sd[key] = value
    out = {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in sd.items()}
    for path in bn_modules:
        out[f"{path}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    if config is not None:
        _check_against_config(out, config, "flax variables")
    return out


def _check_against_config(out: Mapping[str, torch.Tensor], config: ModelConfig, what: str):
    from .umetrack import UmeTrackNet

    want = {k: tuple(v.shape) for k, v in UmeTrackNet(config).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in out.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"{what} do not fit the config: {diff[:8]}")
