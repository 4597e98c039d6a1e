"""Affine / rotation utilities on tensors with arbitrary leading batch dims.

Counterpart of ``umetrack_tpu/geometry/affine.py``: the same closed forms,
written with broadcasting matmuls instead of einsum/vmap.
"""
from __future__ import annotations

import math

import torch

_EPS_NORM = 5.43e-20


def transform_vec3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vectors ``v [..., 3]`` by the upper-left 3x3 of ``m [..., 4, 4]``."""
    return (m[..., :3, :3] @ v[..., None])[..., 0]


def transform3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply a full affine transform ``m [..., 4, 4]`` to points ``v [..., 3]``."""
    return transform_vec3(m, v) + m[..., :3, 3]


def normalized(v: torch.Tensor, dim: int = -1, eps: float = _EPS_NORM) -> torch.Tensor:
    d = torch.clamp((v * v).sum(dim=dim, keepdim=True) ** 0.5, min=eps)
    return v / d


def skew_matrix(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix for ``v [..., 3]`` -> ``[..., 3, 3]``."""
    zero = torch.zeros_like(v[..., 0])
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _eye_like(ref: torch.Tensor, n: int, shape) -> torch.Tensor:
    return torch.eye(n, dtype=ref.dtype, device=ref.device).expand(*shape, n, n)


def rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle ``[..., 3]`` -> rotation matrix ``[..., 3, 3]`` with Taylor
    fallbacks near zero."""
    theta2 = (axis_angle * axis_angle).sum(dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-30))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-30),
    )
    k = skew_matrix(axis_angle)
    eye = _eye_like(axis_angle, 3, k.shape[:-2])
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def from_two_vectors(a_orig: torch.Tensor, b_orig: torch.Tensor) -> torch.Tensor:
    """Rotation matrix aligning ``a`` onto ``b`` (both ``[..., 3]``)."""
    a = normalized(a_orig)
    b = normalized(b_orig)
    v = torch.linalg.cross(a, b, dim=-1)
    s2 = (v * v).sum(dim=-1)
    c = (a * b).sum(dim=-1)
    vm = skew_matrix(v)
    eye = _eye_like(a, 3, vm.shape[:-2])
    scale = (1.0 - c) / torch.clamp(s2, min=1e-15)
    return eye + vm + (vm @ vm) * scale[..., None, None]


def rot_z(angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotation about +z by ``angle_deg`` degrees -> ``[..., 3, 3]``."""
    t = angle_deg * (math.pi / 180.0)
    c, s = torch.cos(t), torch.sin(t)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    rows = [
        torch.stack([c, -s, zero], dim=-1),
        torch.stack([s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def compose_rigid(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``r [..., 3, 3]`` and ``t [..., 3]`` -> ``[..., 4, 4]``."""
    top = torch.cat([r, t[..., None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rigid_inverse(m: torch.Tensor) -> torch.Tensor:
    """Invert ``[..., 4, 4]`` transforms whose 3x3 block is orthogonal
    (rigid, or x-mirrored rigid)."""
    rt = m[..., :3, :3].transpose(-1, -2)
    new_t = -(rt @ m[..., :3, 3:4])[..., 0]
    return compose_rigid(rt, new_t)


def make_look_at_matrix(
    orig_world_to_eye: torch.Tensor,
    center: torch.Tensor,
    camera_angle_deg: torch.Tensor,
) -> torch.Tensor:
    """Keep the camera position, aim its optical axis at ``center`` and roll
    it by ``camera_angle_deg``; returns the new world-to-eye transform."""
    center_local = transform3(orig_world_to_eye, center)
    z_dir_local = normalized(center_local)
    z_axis = torch.zeros_like(z_dir_local)
    z_axis[..., 2] = 1.0
    delta_r_local = from_two_vectors(z_axis, z_dir_local)

    orig_eye_to_world = rigid_inverse(orig_world_to_eye)
    angle = torch.as_tensor(
        camera_angle_deg, dtype=orig_world_to_eye.dtype,
        device=orig_world_to_eye.device,
    )
    new_rot = orig_eye_to_world[..., :3, :3] @ delta_r_local @ rot_z(angle)
    new_eye_to_world = compose_rigid(new_rot, orig_eye_to_world[..., :3, 3])
    return rigid_inverse(new_eye_to_world)
