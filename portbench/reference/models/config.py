"""Typed model configuration.

A copy of ``umetrack_tpu/models/config.py``: the defaults of the original
UmeTrack ``ModelOpts`` (the published checkpoint's architecture, arch
string ``"resnet_layers_2352-f32"``).  The port keeps its own copy so it
never imports the JAX package; it adds the check of ``compute_dtype`` and
:attr:`ModelConfig.torch_dtype`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# The compute dtypes the model runs in; parameters stay float32 in both.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # Backbone: stage block counts and base width (arch "resnet_layers_2352-f32")
    backbone_blocks: Tuple[int, ...] = (2, 3, 5, 2)
    backbone_strides: Tuple[int, ...] = (1, 2, 2, 2)
    start_planes: int = 32
    input_size: Tuple[int, int] = (96, 96)

    # Feature channels
    n_image_feature_channels: int = 72
    n_skeleton_feature_channels: int = 4
    n_memory_channels: int = 18

    # Fusion / temporal / regression depth
    n_fusion_blocks: int = 2
    n_temporal_blocks: int = 3
    n_regression_blocks: int = 2

    # FTL
    spatial_ftl_ratio: float = 1.0
    temporal_ftl_ratio: float = 1.0
    use_unscaled_as_canonical: bool = False
    canonical_focal_length: float = 200.0

    # Regressor
    n_wrist_rigid_pts: int = 7
    # Wrist decode: "quat" (Horn power iteration, fast on TPU) or "svd"
    procrustes_method: str = "quat"

    # Dtypes: params live in f32; convolutions, dense layers, BN outputs
    # and the memory carry are in the compute dtype (a key of COMPUTE_DTYPES).
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype {self.compute_dtype!r}: use one of {sorted(COMPUTE_DTYPES)}"
            )

    @property
    def torch_dtype(self) -> torch.dtype:
        """``compute_dtype`` as a ``torch.dtype``."""
        return COMPUTE_DTYPES[self.compute_dtype]

    @property
    def feature_map_size(self) -> Tuple[int, int]:
        # stem pools /2, resnet strides multiply to /8 -> 96/16 = 6
        s = 2
        for st in self.backbone_strides:
            s *= st
        return (self.input_size[0] // s, self.input_size[1] // s)

    @property
    def stage_in_planes(self) -> Tuple[int, ...]:
        p = self.start_planes
        return (p, p, p * 2, p * 4)

    @property
    def stage_out_planes(self) -> Tuple[int, ...]:
        p = self.start_planes
        return (p, p * 2, p * 4, p * 8)
