"""UmeTrack model assembly: dense-batch, mask-based, state-as-carry.

Counterpart of ``umetrack_tpu/models/umetrack.py``.  Samples are a dense
``[B, V=2]`` layout with an ``n_views`` count per sample; the single-view
and the two-view fused paths are both computed and selected by mask.  The
conv-RNN memory is an explicit :class:`TemporalState`.

Units: images in [0, 1]; extrinsics world->eye in meters; outputs in
meters.  Feature maps and the memory are ``[B, C, h, w]``, NCHW or, in an
eval-mode forward on a card, channels-last (``models/backbone.py``); the
memory carry leaves a step in the layout it came in.

Dtypes follow the JAX model's: the layers compute in
``ModelConfig.compute_dtype`` (``models/backbone.py``), an FTL applies an
f32 transform and so returns f32 features, the memory carry is in the
compute dtype, ``prev_extrinsics`` and the motion geometry are f32, and
every decoded output is f32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .._tree import TensorTree
from ..geometry import affine
from ..ops.bn_act import CHANNELS_LAST, layout
from .backbone import ResNetBackbone
from .components import (
    MultiViewFusion,
    PoseRegressor,
    RegressorOutput,
    SkeletonEncoder,
    TemporalConvStack,
)
from .config import ModelConfig
from .ftl import apply_ftl, singlev_scale_xf

NUM_VIEWS = 2


@dataclasses.dataclass
class FrameInputs(TensorTree):
    """One dense batch of hand samples.

    * images: [B, V, H, W] float in [0, 1] (left-hand canonical crops)
    * intrinsics: [B, V, 3, 3] crop-camera pinhole intrinsics
    * extrinsics: [B, V, 4, 4] world->eye, translation in meters; invalid
      view slots hold a finite orthonormal transform (a copy of view 0)
    * n_views: [B] int, 1 or 2 (valid views packed at the front)
    * hand_idx: [B] int, 0 = left, 1 = right
    * use_memory: [B] bool, whether the temporal memory row is valid
    """

    images: torch.Tensor
    intrinsics: torch.Tensor
    extrinsics: torch.Tensor
    n_views: torch.Tensor
    hand_idx: torch.Tensor
    use_memory: torch.Tensor


@dataclasses.dataclass
class SkeletonInputs(TensorTree):
    """Known user skeleton in meters ([Bs, 22, 3]; Bs == B or 1 shared)."""

    joint_rotation_axes: torch.Tensor
    joint_rest_positions: torch.Tensor


@dataclasses.dataclass
class TemporalState(TensorTree):
    """Explicit conv-RNN carry; row i belongs to batch sample i."""

    mem_features: torch.Tensor  # [B, C_mem, h, w]
    prev_extrinsics: torch.Tensor  # [B, 4, 4] f32, previous crop-cam0 world->eye

    @staticmethod
    def zeros(batch: int, config: ModelConfig, device="cpu") -> "TemporalState":
        """Zero carry: ``mem_features`` in the model's compute dtype, the dtype
        the cell emits it in; ``prev_extrinsics`` is identity and stays
        float32 (pose precision)."""
        h, w = config.feature_map_size
        return TemporalState(
            mem_features=torch.zeros(
                (batch, config.n_memory_channels, h, w), dtype=config.torch_dtype, device=device
            ),
            prev_extrinsics=torch.eye(4, dtype=torch.float32, device=device)
            .expand(batch, 4, 4).contiguous(),
        )


def _scale_xf_inverse(s: torch.Tensor) -> torch.Tensor:
    """Inverse of the z-scale transform produced by singlev_scale_xf."""
    out = s.clone()
    out[..., 2, 2] = 1.0 / s[..., 2, 2]
    return out


def memory_motion_transform(
    cur_extrinsics: torch.Tensor,  # [..., 4, 4] f32 world->cur_cam0
    prev_extrinsics: torch.Tensor,  # [..., 4, 4] f32 world->prev_cam0
    use_memory: torch.Tensor,  # [...] bool
) -> torch.Tensor:  # [..., 4, 4] prev_cam0 -> cur_cam0
    """Gated motion-compensation transform for the conv-RNN memory: rows
    without valid memory substitute identity for ``prev`` so the transform
    stays finite (the memory itself is zeroed by the gate)."""
    eye = torch.eye(4, dtype=torch.float32, device=prev_extrinsics.device)
    safe_prev = torch.where(use_memory[..., None, None], prev_extrinsics, eye)
    return cur_extrinsics @ affine.rigid_inverse(safe_prev)


def _wrist_to_world(
    cam0_extrinsics: torch.Tensor,  # [B, 4, 4] world->cam0
    hand_idx: torch.Tensor,  # [B]
    wrist_cam0: torch.Tensor,  # [B, 4, 4]
) -> torch.Tensor:
    """cam0 -> world, then mirror the x basis column for right hands."""
    world = affine.rigid_inverse(cam0_extrinsics) @ wrist_cam0
    sign = torch.where(hand_idx == 1, -1.0, 1.0).to(world.dtype)
    ones = torch.ones_like(sign)
    col = torch.stack([sign, ones, ones, ones], dim=-1)  # scales columns
    return world * col[:, None, :]


class UmeTrackNet(nn.Module):
    """Feature extractor + temporal cell + skeleton encoder + two regressors
    (``regressor_k`` with a known skeleton, ``regressor_u`` predicting the
    skeleton scale), computing in ``config.compute_dtype`` with f32
    parameters."""

    def __init__(self, config: Optional[ModelConfig] = None):
        super().__init__()
        cfg = config or ModelConfig()
        self.config = cfg
        dtype = cfg.torch_dtype
        c_img = cfg.n_image_feature_channels
        self.backbone = ResNetBackbone(cfg)
        self.fusion = MultiViewFusion(c_img * NUM_VIEWS, c_img, cfg.n_fusion_blocks, dtype)
        self.temporal = TemporalConvStack(
            c_img + cfg.n_memory_channels, cfg.n_temporal_blocks, dtype
        )
        self.skeleton_encoder = SkeletonEncoder(
            cfg.n_skeleton_feature_channels, cfg.feature_map_size, dtype=dtype
        )
        self.regressor_k = PoseRegressor(
            cfg, c_img + cfg.n_skeleton_feature_channels, predict_skel_scale=False
        )
        self.regressor_u = PoseRegressor(cfg, c_img, predict_skel_scale=True)

    # ---- feature extraction -------------------------------------------------

    def _multiv_xfs(
        self, singlev_xf: torch.Tensor, extrinsics: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-view scaled->canonical [B, V, 4, 4] and canonical->cam0
        [B, 4, 4] transforms."""
        xf0 = extrinsics[:, 0:1]
        xf_to_world = affine.rigid_inverse(extrinsics) @ singlev_xf
        if self.config.use_unscaled_as_canonical:
            canonical_to_cam0 = torch.eye(
                4, dtype=extrinsics.dtype, device=extrinsics.device
            ).expand(extrinsics.shape[0], 4, 4)
            scaled_to_canonical = xf0 @ xf_to_world
        else:
            canonical_to_cam0 = singlev_xf[:, 0]
            s0_inv = _scale_xf_inverse(singlev_xf[:, 0:1])
            scaled_to_canonical = s0_inv @ xf0 @ xf_to_world
        return scaled_to_canonical, canonical_to_cam0

    def extract_features(self, frame: FrameInputs) -> torch.Tensor:
        """Backbone + FTL + multi-view fusion: [B, V, H, W] crops -> fused
        [B, C, h, w] features in cam0 space.  Independent of the recurrent
        state, so the sequence trackers run it over all (sequence, time)
        rows at once."""
        cfg = self.config
        b, v = frame.images.shape[:2]
        feats = self.backbone(frame.images.reshape(b * v, 1, *frame.images.shape[2:]))
        feats = feats.reshape(b, v, *feats.shape[1:])  # [B, V, C, h, w]

        singlev_xf = singlev_scale_xf(frame.intrinsics, cfg.canonical_focal_length)
        scaled_to_canon, canon_to_cam0 = self._multiv_xfs(singlev_xf, frame.extrinsics)
        canon_feats = apply_ftl(scaled_to_canon, feats, cfg.spatial_ftl_ratio)
        stacked = torch.cat([canon_feats[:, i] for i in range(v)], dim=1)
        multiv_out = apply_ftl(canon_to_cam0, self.fusion(stacked), cfg.spatial_ftl_ratio)
        singlev_out = apply_ftl(singlev_xf[:, 0], feats[:, 0], cfg.spatial_ftl_ratio)
        is_multi = (frame.n_views > 1)[:, None, None, None]
        return torch.where(is_multi, multiv_out, singlev_out)

    # ---- temporal -----------------------------------------------------------

    def temporal_step(
        self,
        img_features: torch.Tensor,  # [B, C_img, h, w]
        mem_transform: torch.Tensor,  # [B, 4, 4] f32 prev_cam0 -> cur_cam0
        use_memory: torch.Tensor,  # [B] bool
        mem_features: torch.Tensor,  # [B, C_mem, h, w]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One conv-RNN cell step on precomputed inputs -> (fused, new_mem).
        The memory is warped by the f32 transform and cast back to its own
        dtype, as the JAX cell does; the new memory has the old one's
        layout (a captured step's key holds its inputs' strides)."""
        cfg = self.config
        compensated = apply_ftl(
            mem_transform, mem_features, cfg.temporal_ftl_ratio
        ).to(mem_features.dtype)
        mem_in = torch.where(
            use_memory[:, None, None, None], compensated, torch.zeros_like(mem_features)
        )
        tout = self.temporal(torch.cat([mem_in, img_features], dim=1))
        new_mem = tout[:, :cfg.n_memory_channels]
        if layout(new_mem) == CHANNELS_LAST and layout(mem_features) != CHANNELS_LAST:
            new_mem = new_mem.contiguous()
        return tout[:, cfg.n_memory_channels:], new_mem

    def _temporal_features(
        self, img_features: torch.Tensor, frame: FrameInputs, state: TemporalState
    ) -> Tuple[torch.Tensor, TemporalState]:
        cur_e = frame.extrinsics[:, 0].to(torch.float32)
        xf = memory_motion_transform(cur_e, state.prev_extrinsics, frame.use_memory)
        fused, new_mem = self.temporal_step(
            img_features, xf, frame.use_memory, state.mem_features
        )
        return fused, TemporalState(mem_features=new_mem, prev_extrinsics=cur_e)

    # ---- heads --------------------------------------------------------------

    def encode_skeleton(self, skeleton: SkeletonInputs) -> torch.Tensor:
        """Skeleton-encoder features [Bs, C_skel, h, w] (constant over time)."""
        return self.skeleton_encoder(
            skeleton.joint_rotation_axes, skeleton.joint_rest_positions
        )

    def regress_known(
        self,
        fused: torch.Tensor,  # [B, C_img, h, w] temporal-cell output
        skel_feats: torch.Tensor,  # [B or 1, C_skel, h, w]
        hand_idx: torch.Tensor,  # [B]
        cam0_extrinsics: torch.Tensor,  # [B, 4, 4] world->cam0 (meters)
    ) -> RegressorOutput:
        """Known-skeleton regressor head on precomputed temporal features."""
        b = fused.shape[0]
        if skel_feats.shape[0] == 1 and b > 1:
            skel_feats = skel_feats.expand(b, *skel_feats.shape[1:])
        out = self.regressor_k(torch.cat([fused, skel_feats], dim=1))
        return dataclasses.replace(
            out, wrist_xfs=_wrist_to_world(cam0_extrinsics, hand_idx, out.wrist_xfs)
        )

    def regress_scale(
        self,
        fused: torch.Tensor,  # [B, C_img, h, w] temporal-cell output
        hand_idx: torch.Tensor,  # [B]
        cam0_extrinsics: torch.Tensor,  # [B, 4, 4] world->cam0 (meters)
    ) -> RegressorOutput:
        """Scale-predicting regressor head on precomputed temporal features."""
        out = self.regressor_u(fused)
        return dataclasses.replace(
            out, wrist_xfs=_wrist_to_world(cam0_extrinsics, hand_idx, out.wrist_xfs)
        )

    def known_skeleton(
        self, frame: FrameInputs, skeleton: SkeletonInputs, state: TemporalState
    ) -> Tuple[RegressorOutput, TemporalState]:
        """Pose regression given a calibrated skeleton, one frame."""
        img_features = self.extract_features(frame)
        fused, new_state = self._temporal_features(img_features, frame, state)
        out = self.regress_known(
            fused, self.encode_skeleton(skeleton), frame.hand_idx, frame.extrinsics[:, 0]
        )
        return out, new_state

    def predict_scale(
        self, frame: FrameInputs, state: TemporalState
    ) -> Tuple[RegressorOutput, TemporalState]:
        """Pose and skeleton-scale regression without a skeleton, one frame;
        callers supply two-view samples only."""
        img_features = self.extract_features(frame)
        fused, new_state = self._temporal_features(img_features, frame, state)
        out = self.regress_scale(fused, frame.hand_idx, frame.extrinsics[:, 0])
        return out, new_state

    forward = known_skeleton


# flax's ``variance_scaling(..., "truncated_normal")`` divides the standard
# deviation by that of a unit normal truncated to [-2, 2]
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn on the CPU from ``generator``, from the
    distribution flax's defaults give the JAX package's layers: conv and
    dense kernels ``lecun_normal`` (a normal of std 1/sqrt(fan_in), fan_in
    = kh*kw*c_in, truncated at two of its stds), biases 0, BN scale 1 and
    bias 0, running mean 0 and running var 1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                std = m.weight[0].numel() ** -0.5 / _TRUNCATED_NORMAL_STD
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.reset_running_stats()
    return model


def make_model(
    config: Optional[ModelConfig] = None, seed: int = 0, device="cpu"
) -> UmeTrackNet:
    """A :class:`UmeTrackNet` in eval mode with seeded random weights
    (:func:`init_weights`: flax's default draw)."""
    return init_model(torch.Generator().manual_seed(seed), config, device)[0]


def init_model(
    generator: torch.Generator, config: Optional[ModelConfig] = None, device="cpu"
) -> Tuple[UmeTrackNet, Dict[str, torch.Tensor]]:
    """(model, its state dict): a :class:`UmeTrackNet` of ``config`` in eval
    mode with random weights drawn from ``generator`` from flax's default
    distribution (:func:`init_weights`), as the JAX package's
    ``init_model(rng, config)`` returns (model, variables)."""
    model = init_weights(UmeTrackNet(config), generator).to(device).eval()
    return model, model.state_dict()
