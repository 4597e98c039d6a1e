"""Fisheye62 camera model on tensors.

Counterpart of ``umetrack_tpu/geometry/cameras.py``: the equidistant
(arctan) projection followed by the 6-radial + 2-tangential distortion
polynomial, with every field carrying arbitrary leading batch dims.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import affine


def arctan_project(v: torch.Tensor, eps: float = 1e-18) -> torch.Tensor:
    """Equidistant fisheye projection of eye points ``[..., 3]`` -> ``[..., 2]``.

    ``eps`` stays a normal float32 so the on-axis point (r == 0) maps to 0
    instead of 0/0."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    r = torch.sqrt(x * x + y * y)
    s = torch.atan2(r, z) / torch.clamp(r, min=eps)
    return torch.stack([x * s, y * s], dim=-1)


def fisheye62_distort(coeffs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``coeffs [..., 8]`` ordered (k1 k2 k3 k4 p1 p2 k5 k6); ``p [..., 2]``.
    The coefficient batch dims broadcast against ``p[..., 0]``."""
    k1, k2, k3, k4 = (coeffs[..., i] for i in range(4))
    p1, p2 = coeffs[..., 4], coeffs[..., 5]
    k5, k6 = coeffs[..., 6], coeffs[..., 7]

    r2 = (p * p).sum(dim=-1)
    r2 = torch.clamp(r2, -math.pi ** 2, math.pi ** 2)
    r4 = r2 * r2
    r6 = r2 * r4
    r8 = r4 * r4
    r10 = r4 * r6
    r12 = r6 * r6
    radial = 1 + k1 * r2 + k2 * r4 + k3 * r6 + k4 * r8 + k5 * r10 + k6 * r12
    uv = p * radial[..., None]

    x, y = uv[..., 0], uv[..., 1]
    x2, y2, xy = x * x, y * y, x * y
    r2t = x2 + y2
    xd = x + 2 * p2 * xy + p1 * (r2t + 2 * x2)
    yd = y + 2 * p1 * xy + p2 * (r2t + 2 * y2)
    return torch.stack([xd, yd], dim=-1)


@dataclasses.dataclass
class Fisheye62Camera:
    """Fisheye camera; every field may carry the same leading batch dims."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    T_world_from_eye: torch.Tensor  # [..., 4, 4]
    coeffs: torch.Tensor  # [..., 8]

    @property
    def f(self) -> torch.Tensor:
        return torch.stack([self.fx, self.fy], dim=-1)

    @property
    def c(self) -> torch.Tensor:
        return torch.stack([self.cx, self.cy], dim=-1)

    def world_to_eye(self, p_world: torch.Tensor) -> torch.Tensor:
        t = self.T_world_from_eye
        return affine.transform_vec3(t.transpose(-1, -2), p_world - t[..., :3, 3])

    def eye_to_window(self, v_eye: torch.Tensor) -> torch.Tensor:
        q = fisheye62_distort(self.coeffs, arctan_project(v_eye))
        return q * self.f + self.c

    def world_to_window(self, p_world: torch.Tensor) -> torch.Tensor:
        return self.eye_to_window(self.world_to_eye(p_world))
