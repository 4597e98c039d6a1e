"""Crop-camera fitting: aim a pinhole camera at a point cloud.

Counterpart of ``umetrack_tpu/geometry/crop.py``: look-at re-aim, optional
x-mirror for right hands, focal fit with the -0.5-pixel-center convention
and a focal multiplier margin.  Degenerate geometry sets ``valid`` to False
instead of raising, and the projective division is guarded so masked lanes
stay finite.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .._device import device_constant
from . import affine


@dataclasses.dataclass
class CropCamera:
    """Fitted pinhole crop cameras plus validity flags (batch dims ``[...]``)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    T_world_from_eye: torch.Tensor  # [..., 4, 4]
    valid: torch.Tensor  # [...] bool

    def intrinsics_matrix(self) -> torch.Tensor:
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        rows = [
            torch.stack([self.fx, z, self.cx], dim=-1),
            torch.stack([z, self.fy, self.cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ]
        return torch.stack(rows, dim=-2)


def gen_crop_camera_from_points(
    T_world_from_eye_orig: torch.Tensor,  # [..., 4, 4]
    pts_world: torch.Tensor,  # [..., N, 3]
    image_size: Tuple[int, int],  # (width, height)
    mirror_img_x: torch.Tensor,  # [...] bool
    camera_angle_deg: torch.Tensor,  # [...]
    focal_multiplier: float = 0.95,
    min_focal: float = 5.0,
) -> CropCamera:
    """Fit crop cameras enclosing ``pts_world``; all batch dims broadcast."""
    orig_world_to_eye = affine.rigid_inverse(T_world_from_eye_orig)
    crop_center = (pts_world.amin(dim=-2) + pts_world.amax(dim=-2)) / 2.0
    new_world_to_eye = affine.make_look_at_matrix(
        orig_world_to_eye, crop_center, camera_angle_deg
    )
    dtype, device = new_world_to_eye.dtype, new_world_to_eye.device
    mirror_diag = torch.where(
        torch.as_tensor(mirror_img_x, device=device)[..., None],
        device_constant([-1.0, 1.0, 1.0, 1.0], dtype, device),
        torch.ones(4, dtype=dtype, device=device),
    )
    new_world_to_eye = torch.diag_embed(mirror_diag) @ new_world_to_eye

    pts_eye = affine.transform3(new_world_to_eye[..., None, :, :], pts_world)
    z = pts_eye[..., 2]
    img_size = device_constant(image_size, pts_eye.dtype, device)
    cx_cy = (img_size - 1.0) / 2.0
    safe_z = torch.where(
        pts_eye[..., 2:3].abs() < 1e-6,
        torch.ones_like(pts_eye[..., 2:3]),
        pts_eye[..., 2:3],
    )
    ndc = pts_eye[..., 0:2] / safe_z
    max_ndc = ndc.abs().flatten(-2).amax(dim=-1)  # [...]
    fx_fy = cx_cy / torch.clamp(max_ndc, min=1e-12)[..., None]  # [..., 2]

    valid = (z >= 1e-4).all(dim=-1) & (fx_fy >= min_focal).all(dim=-1)
    fx_fy = focal_multiplier * fx_fy
    cx_cy = cx_cy.expand_as(fx_fy)

    return CropCamera(
        fx=fx_fy[..., 0],
        fy=fx_fy[..., 1],
        cx=cx_cy[..., 0],
        cy=cx_cy[..., 1],
        T_world_from_eye=affine.rigid_inverse(new_world_to_eye),
        valid=valid,
    )
