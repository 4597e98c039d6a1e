"""Feature Transform Layer (FTL) for [..., C, H, W] feature maps.

Counterpart of ``umetrack_tpu/models/ftl.py``.  The leading
``round(C * ratio)`` channels are read as the X / Y / Z thirds of
(C/3 * H * W) points and rigidly transformed; the thirds are channel
slices along dim -3, views in NCHW and in channels-last alike.
"""
from __future__ import annotations

import torch


def apply_ftl(
    xfs: torch.Tensor,  # [..., 4, 4]
    features: torch.Tensor,  # [..., C, H, W]
    ftl_ratio: float = 1.0,
) -> torch.Tensor:
    """Rigid-transform the leading ``round(C * ftl_ratio)`` channels as 3D
    points; ``xfs`` batch dims match the feature batch dims."""
    if not 0.0 <= ftl_ratio <= 1.0:
        raise ValueError(f"ftl_ratio {ftl_ratio} outside [0, 1]")
    if ftl_ratio == 0.0:
        return features

    c = features.shape[-3]
    nc_ftl = int(round(c * ftl_ratio))
    if nc_ftl % 3:
        raise ValueError(f"FTL channels {nc_ftl} not divisible by 3")
    c3 = nc_ftl // 3

    x = features[..., 0 * c3:1 * c3, :, :]
    y = features[..., 1 * c3:2 * c3, :, :]
    z = features[..., 2 * c3:3 * c3, :, :]

    def e(i, j):
        return xfs[..., i, j][..., None, None, None]

    def tt(i):
        return xfs[..., i, 3][..., None, None, None]

    xo = e(0, 0) * x + e(0, 1) * y + e(0, 2) * z + tt(0)
    yo = e(1, 0) * x + e(1, 1) * y + e(1, 2) * z + tt(1)
    zo = e(2, 0) * x + e(2, 1) * y + e(2, 2) * z + tt(2)

    parts = [xo, yo, zo]
    if nc_ftl != c:
        parts.append(features[..., nc_ftl:, :, :])
    return torch.cat(parts, dim=-3)


def singlev_scale_xf(
    intrinsics: torch.Tensor,  # [..., 3, 3]
    canonical_focal_length: float = 200.0,
) -> torch.Tensor:  # [..., 4, 4]
    """Intrinsics factorization K = K_canonical * S; S scales z by f / f_c."""
    focal = intrinsics[..., 0, 0]
    ones = torch.ones_like(focal)
    diag = torch.stack([ones, ones, focal / canonical_focal_length, ones], dim=-1)
    return torch.diag_embed(diag)
