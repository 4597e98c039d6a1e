"""Flax variables <-> port state dict, and the reference model's names.

The port's submodules are named after the flax tree (``backbone.stem_conv``,
``fusion.conv0``, ``regressor_k.block1.bn2``, ...), so the mapping is a
plain walk over ``{"params", "batch_stats"}``:

- conv kernels HWIO -> OIHW, Dense kernels ``(in, out)`` -> ``(out, in)``;
- BatchNorm ``scale``/``bias`` -> ``weight``/``bias`` and ``mean``/``var``
  -> ``running_mean``/``running_var`` (plus ``num_batches_tracked``).

Works from numpy arrays, so the caller that holds JAX arrays converts them
with ``np.asarray`` first.  :func:`to_flax_variables` is the inverse walk.

:func:`from_reference_state_dict` renames a state dict of the original
UmeTrack torch model (``_feature_extractor._image_backbone.0._layers...``)
to the port's names; its tensors are already OIHW, so nothing is transposed.
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


def to_flax_variables(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """The inverse of :func:`from_flax_variables`: a port state dict ->
    ``{"params": ..., "batch_stats": ...}`` with float32 numpy leaves (conv
    OIHW -> HWIO, Linear transposed, BN ``weight`` -> ``scale``, running
    stats -> ``mean``/``var``; ``num_batches_tracked`` has no flax leaf and
    is dropped).  Keys are sorted at every level below the top, the order
    flax writes."""
    sd = {k: np.asarray(v.detach().cpu() if torch.is_tensor(v) else v) for k, v in state_dict.items()}
    bn_modules = {k.rsplit(".", 1)[0] for k in sd if k.endswith(".running_mean")}
    stats_names = {"running_mean": "mean", "running_var": "var"}
    flat = {"params": {}, "batch_stats": {}}
    for key, a in sd.items():
        path, leaf = key.rsplit(".", 1)
        a = a.astype(np.float32)
        if leaf == "num_batches_tracked":
            continue
        if leaf in stats_names:
            flat["batch_stats"][f"{path}.{stats_names[leaf]}"] = a
        elif leaf == "bias":
            flat["params"][f"{path}.bias"] = a
        elif leaf != "weight":
            raise ValueError(f"unexpected state dict entry {key}")
        elif path in bn_modules:
            flat["params"][f"{path}.scale"] = a
        elif a.ndim == 4:  # conv OIHW -> HWIO
            flat["params"][f"{path}.kernel"] = np.ascontiguousarray(np.transpose(a, (2, 3, 1, 0)))
        elif a.ndim == 2:  # Linear (out, in) -> Dense (in, out)
            flat["params"][f"{path}.kernel"] = np.ascontiguousarray(a.T)
        else:
            raise ValueError(f"unexpected weight rank {a.ndim} at {key}")
    out: Dict[str, Dict] = {}
    for top, leaves in flat.items():
        tree: Dict[str, Any] = {}
        for key in sorted(leaves):
            node = tree
            *parents, leaf = key.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = leaves[key]
        out[top] = tree
    return out


def reference_module_names(config: Optional[ModelConfig] = None) -> Dict[str, str]:
    """Module names of the original UmeTrack torch model -> the port's."""
    cfg = config or ModelConfig()
    names: Dict[str, str] = {}

    def basic_block(ref: str, ours: str, has_downsample: bool):
        for m in ("conv1", "bn1", "conv2", "bn2"):
            names[f"{ref}.{m}"] = f"{ours}.{m}"
        if has_downsample:
            names[f"{ref}.downsample.0"] = f"{ours}.downsample_conv"
            names[f"{ref}.downsample.1"] = f"{ours}.downsample_bn"

    bb = "_feature_extractor._image_backbone"
    names[f"{bb}.0._layers.0.0"] = "backbone.stem_conv"
    names[f"{bb}.0._layers.0.1"] = "backbone.stem_bn"
    names[f"{bb}.1"] = "backbone.proj_conv"
    in_planes, out_planes = cfg.stage_in_planes, cfg.stage_out_planes
    for si, (n_blocks, stride) in enumerate(zip(cfg.backbone_blocks, cfg.backbone_strides)):
        for bi in range(n_blocks):
            has_ds = bi == 0 and (stride != 1 or in_planes[si] != out_planes[si])
            basic_block(f"{bb}.0._layers.{si + 1}.{bi}", f"backbone.stage{si}_block{bi}", has_ds)

    fu = "_feature_extractor._multi_view_fusion"  # [Conv, BN, ReLU] * n + Conv
    for i in range(cfg.n_fusion_blocks):
        names[f"{fu}.{3 * i}"] = f"fusion.conv{i}"
        names[f"{fu}.{3 * i + 1}"] = f"fusion.bn{i}"
    names[f"{fu}.{3 * cfg.n_fusion_blocks}"] = "fusion.conv_out"

    for i in range(cfg.n_temporal_blocks):  # [Conv, ReLU] * (n - 1) + Conv
        names[f"_temporal._temporal_module.{2 * i}"] = f"temporal.conv{i}"

    names["_skeleton_enc._layers.0"] = "skeleton_encoder.linear"  # [Linear, View, BN, ReLU]
    names["_skeleton_enc._layers.2"] = "skeleton_encoder.bn"

    for ours in ("regressor_k", "regressor_u"):  # [BasicBlock * n, Conv, AvgPool]
        pr = f"_{ours}._pose_regression_layers"
        for i in range(cfg.n_regression_blocks):
            basic_block(f"{pr}.{i}", f"{ours}.block{i}", False)
        names[f"{pr}.{cfg.n_regression_blocks}"] = f"{ours}.conv_out"
    return names


def from_reference_state_dict(
    sd: Mapping[str, Any], config: Optional[ModelConfig] = None
) -> Dict[str, torch.Tensor]:
    """Rename a state dict of the original UmeTrack torch model to the
    port's names and check it against the port's model of ``config``.
    Entries of modules the port does not have raise."""
    cfg = config or ModelConfig()
    names = reference_module_names(cfg)
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        path, leaf = key.rsplit(".", 1)
        if path not in names:
            raise ValueError(f"reference state dict entry {key} has no counterpart")
        a = torch.as_tensor(value)
        out[f"{names[path]}.{leaf}"] = a if leaf == "num_batches_tracked" else a.to(torch.float32)
    _check_against_config(out, cfg, "reference weights")
    return out


# The JAX package's name for the conversion of the original model's weights.
convert_state_dict = from_reference_state_dict


def load_torch_checkpoint(path: str, config: Optional[ModelConfig] = None) -> Dict[str, torch.Tensor]:
    """A ``.torch`` state dict of the original UmeTrack model, renamed to
    the port's names and checked against ``config``."""
    with open(path, "rb") as fp:
        sd = torch.load(fp, map_location="cpu", weights_only=True)
    return from_reference_state_dict(sd, config)
