"""Camera models on tensors: pinhole and fisheye62.

Counterpart of ``umetrack_tpu/geometry/cameras.py``: the perspective
projection and its unit-ray inverse, the equidistant (arctan) projection
and its inverse, the 6-radial + 2-tangential distortion polynomial, and
the two camera types with every field carrying arbitrary leading batch
dims.  Unprojection is pinhole-only.

Conventions: ``v`` a 3D point or direction in eye space, ``p`` projected
uv, ``q`` distorted uv, ``w`` window (pixel) coordinates; window =
q * f + c, pixel centres at integer coordinates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import resolve_device
from . import affine


def perspective_project(v: torch.Tensor) -> torch.Tensor:
    """``[..., 3]`` eye points -> ``[..., 2]`` uv on the z=1 plane."""
    return v[..., :2] / v[..., 2:3]


def perspective_unproject(p: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` uv -> ``[..., 3]`` unit-length eye ray; project o
    unproject is the identity."""
    return affine.normalized(torch.cat([p, torch.ones_like(p[..., :1])], dim=-1))


def arctan_project(v: torch.Tensor, eps: float = 1e-18) -> torch.Tensor:
    """Equidistant fisheye projection of eye points ``[..., 3]`` -> ``[..., 2]``.

    ``eps`` stays a normal float32 so the on-axis point (r == 0) maps to 0
    instead of 0/0."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    r = torch.sqrt(x * x + y * y)
    s = torch.atan2(r, z) / torch.clamp(r, min=eps)
    return torch.stack([x * s, y * s], dim=-1)


def arctan_unproject(uv: torch.Tensor) -> torch.Tensor:
    """Inverse equidistant projection: ``[..., 2]`` -> ``[..., 3]`` unit
    rays (``sinc`` is the normalised one, so ``sinc(r / pi) = sin(r) / r``)."""
    u, v = uv[..., 0], uv[..., 1]
    r = torch.sqrt(u * u + v * v)
    s = torch.sinc(r / math.pi)
    return torch.stack([u * s, v * s, torch.cos(r)], dim=-1)


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


class _CameraOps:
    """The rigid-transform helpers both camera types share;
    ``T_world_from_eye [..., 4, 4]``."""

    @property
    def f(self) -> torch.Tensor:
        return torch.stack([self.fx, self.fy], dim=-1)

    @property
    def c(self) -> torch.Tensor:
        return torch.stack([self.cx, self.cy], dim=-1)

    def world_to_eye(self, p_world: torch.Tensor) -> torch.Tensor:
        t = self.T_world_from_eye
        return affine.transform_vec3(t.transpose(-1, -2), p_world - t[..., :3, 3])

    def eye_to_world(self, v_eye: torch.Tensor) -> torch.Tensor:
        return affine.transform3(self.T_world_from_eye, v_eye)

    def world_to_window(self, p_world: torch.Tensor) -> torch.Tensor:
        return self.eye_to_window(self.world_to_eye(p_world))


@dataclasses.dataclass
class PinholeCamera(_CameraOps):
    """Distortion-free perspective camera; every field may carry the same
    leading batch dims, which broadcast against the points'."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    T_world_from_eye: torch.Tensor  # [..., 4, 4]

    def eye_to_window(self, v_eye: torch.Tensor) -> torch.Tensor:
        return perspective_project(v_eye) * self.f + self.c

    def window_to_eye(self, w: torch.Tensor) -> torch.Tensor:
        return perspective_unproject((w - self.c) / self.f)

    def uv_to_window_matrix(self) -> torch.Tensor:
        """The ``[..., 3, 3]`` intrinsics matrix."""
        z, o = torch.zeros_like(self.fx), torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx], dim=-1),
            torch.stack([z, self.fy, self.cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ], dim=-2)


@dataclasses.dataclass
class Fisheye62Camera(_CameraOps):
    """Fisheye camera; every field may carry the same leading batch dims."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    T_world_from_eye: torch.Tensor  # [..., 4, 4]
    coeffs: torch.Tensor  # [..., 8]

    def eye_to_window(self, v_eye: torch.Tensor) -> torch.Tensor:
        q = fisheye62_distort(self.coeffs, arctan_project(v_eye))
        return q * self.f + self.c


FISHEYE62_COEFFS = ("k1", "k2", "k3", "k4", "p1", "p2", "k5", "k6")


def camera_from_json(js: Dict[str, Any], T_world_from_eye: Optional[np.ndarray] = None,
                     device=None):
    """A camera from the original JSON schema (optionally under a ``Camera``
    key): ``DistortionModel`` ``PinholePlane`` gives a
    :class:`PinholeCamera`, ``FishEye62`` a :class:`Fisheye62Camera`; any
    other model raises.  Scalar f32 fields on ``device`` (CUDA unless
    "cpu"); ``T_world_from_eye`` defaults to the identity."""
    device = resolve_device(device)
    if "Camera" in js:
        js = js["Camera"]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    common = dict(
        fx=t(float(js["fx"])), fy=t(float(js["fy"])),
        cx=t(float(js["cx"])), cy=t(float(js["cy"])),
        width=t(float(js["ImageSizeX"])), height=t(float(js["ImageSizeY"])),
        T_world_from_eye=t(np.eye(4) if T_world_from_eye is None else T_world_from_eye),
    )
    model = js["DistortionModel"]
    if model == "PinholePlane":
        return PinholeCamera(**common)
    if model == "FishEye62":
        return Fisheye62Camera(coeffs=t([float(js[n]) for n in FISHEYE62_COEFFS]), **common)
    raise ValueError(f"unknown DistortionModel: {model!r}")
