"""Model sub-components (NCHW, or channels-last as ``models/backbone.py``
says): multi-view fusion, the temporal conv-RNN cell, the skeleton encoder
and the pose-regression head.

Counterpart of ``umetrack_tpu/models/components.py``; submodule names
follow the flax tree (``fusion.conv0``, ``regressor_k.block1.bn2``, ...).
Each module computes in its ``dtype`` (``models/backbone.py`` says how);
the regressor's decode runs in f32 whatever it is.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .._tree import TensorTree
from ..ops.bn_act import batch_norm_act
from .backbone import BasicBlock, BatchNorm, Conv, Dense, one_pass
from .config import ModelConfig
from .procrustes import procrustes_align


class MultiViewFusion(nn.Module):
    """1x1-conv ladder stepping channels nc_in -> nc_out linearly, then one
    extra 1x1 conv so features aren't all-positive after the final ReLU."""

    def __init__(self, nc_in: int, nc_out: int, n_blocks: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        channels = [int(c) for c in np.linspace(nc_in, nc_out, n_blocks + 1)]
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"conv{i}", Conv(channels[i], channels[i + 1], 1, compute_dtype=dtype))
            self.add_module(f"bn{i}", BatchNorm(channels[i + 1], dtype))
        self.conv_out = Conv(channels[-1], nc_out, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            if one_pass(x, conv, bn):
                y, bias = conv.without_bias(x)
                x = batch_norm_act(y, bn, conv_bias=bias)
            else:
                x = F.relu(bn(conv(x)))
        return self.conv_out(x)


class TemporalConvStack(nn.Module):
    """The conv-RNN cell body: n 1x1 convs at constant width, ReLU between
    (not after the last).  Input = concat([memory, image features])."""

    def __init__(self, n_channels: int, n_blocks: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(n_blocks):
            self.add_module(f"conv{i}", Conv(n_channels, n_channels, 1, compute_dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_blocks):
            x = getattr(self, f"conv{i}")(x)
            if i != self.n_blocks - 1:
                x = F.relu(x)
        return x


class SkeletonEncoder(nn.Module):
    """22 joints x (axis 3 + rest position 3) = 132 -> Linear -> feature
    map viewed as (C, H, W), then BN + ReLU."""

    def __init__(self, out_channels: int, feature_map_size: Tuple[int, int],
                 n_joints: int = 22, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_channels = out_channels
        self.feature_map_size = tuple(feature_map_size)
        h, w = self.feature_map_size
        self.linear = Dense(n_joints * 6, out_channels * h * w, compute_dtype=dtype)
        self.bn = BatchNorm(out_channels, dtype)

    def forward(self, joint_rotation_axes: torch.Tensor,
                joint_rest_positions: torch.Tensor) -> torch.Tensor:
        b = joint_rotation_axes.shape[0]
        feats = torch.cat([joint_rotation_axes, joint_rest_positions], dim=-1).reshape(b, -1)
        x = self.linear(feats).view(b, self.out_channels, *self.feature_map_size)
        if one_pass(x, self.bn):
            return batch_norm_act(x, self.bn)
        return F.relu(self.bn(x))


def gen_rigid_points(n_points: int = 7, dtype=np.float32) -> np.ndarray:
    """Canonical wrist rigid sample points, norm 0.1."""
    pts = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1],
         [-1, -1, 0], [-1, 0, -1], [0, -1, -1]],
        dtype=np.float64,
    )
    norms = np.linalg.norm(pts, axis=-1, keepdims=True)
    scaled = np.where(norms == 0, pts, pts / np.maximum(norms, 1e-12) * 0.1)
    assert n_points <= len(pts)
    return scaled[:n_points].astype(dtype)


def output_layout(n_wrist_rigid_pts: int, predict_skel_scale: bool):
    """Output vector layout: {name: (start, stop)} and total dim."""
    dims = {
        "joint_angles": 20,
        "wrist_xfs": n_wrist_rigid_pts * 3,
        "skel_scales": 1 if predict_skel_scale else 0,
        "landmark_uncertainty_sigmas": 21,
    }
    ranges: Dict[str, Tuple[int, int]] = {}
    n = 0
    for k, v in dims.items():
        if v:
            ranges[k] = (n, n + v)
            n += v
    return ranges, n


@dataclasses.dataclass
class RegressorOutput(TensorTree):
    joint_angles: torch.Tensor  # [B, 22]
    wrist_xfs: torch.Tensor  # [B, 4, 4]
    landmark_uncertainty_sigmas: torch.Tensor  # [B, 21]
    skel_scales: Optional[torch.Tensor] = None  # [B]
    wrist_points: Optional[torch.Tensor] = None  # [B, n_rigid_pts, 3]


class PoseRegressor(nn.Module):
    """n BasicBlocks + 1x1 conv to output dims + global average pool, then
    per-range decoders (angles, Procrustes wrist, exp scale, softplus
    sigmas).  The blocks, the output conv and the pool run in the compute
    dtype; the decode runs in float32."""

    def __init__(self, cfg: ModelConfig, n_in: int, predict_skel_scale: bool):
        super().__init__()
        self.cfg = cfg
        self.predict_skel_scale = predict_skel_scale
        self.ranges, n_out = output_layout(cfg.n_wrist_rigid_pts, predict_skel_scale)
        dtype = cfg.torch_dtype
        for i in range(cfg.n_regression_blocks):
            self.add_module(f"block{i}", BasicBlock(n_in, n_in, dtype=dtype))
        self.conv_out = Conv(n_in, n_out, 1, compute_dtype=dtype)
        self.register_buffer(
            "rigid_points", torch.from_numpy(gen_rigid_points(cfg.n_wrist_rigid_pts)),
            persistent=False,
        )

    def forward(self, x: torch.Tensor) -> RegressorOutput:
        for i in range(self.cfg.n_regression_blocks):
            x = getattr(self, f"block{i}")(x)
        pose_features = self.conv_out(x).mean(dim=(2, 3)).to(torch.float32)

        b = pose_features.shape[0]
        r0, r1 = self.ranges["joint_angles"]
        joint_angles = torch.cat(
            [pose_features[:, r0:r1], pose_features.new_zeros(b, 2)], dim=-1
        )
        r0, r1 = self.ranges["wrist_xfs"]
        pred_pts = pose_features[:, r0:r1].reshape(b, -1, 3)
        from_pts = self.rigid_points.to(pred_pts.dtype).expand(b, -1, -1)
        wrist_xfs = procrustes_align(from_pts, pred_pts, self.cfg.procrustes_method)

        skel_scales = None
        if self.predict_skel_scale:
            skel_scales = torch.exp(pose_features[:, self.ranges["skel_scales"][0]])

        r0, r1 = self.ranges["landmark_uncertainty_sigmas"]
        sigmas = torch.clamp(F.softplus(pose_features[:, r0:r1]), min=1e-5)
        return RegressorOutput(
            joint_angles=joint_angles,
            wrist_xfs=wrist_xfs,
            landmark_uncertainty_sigmas=sigmas,
            skel_scales=skel_scales,
            wrist_points=pred_pts,
        )
