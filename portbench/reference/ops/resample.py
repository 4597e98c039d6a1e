"""Image warping: the crop coordinate field and the plain bilinear samplers.

The plain parts of the port's ``ops/resample.py``, frozen: the pool
sampler :func:`bilinear_sample_pool_plain` (what the CUDA pool-warp kernel
computes), its single-image form, the shared ``_sample_prep`` rule and the
per-pixel fisheye -> pinhole crop field :func:`fisheye_to_pinhole_coords`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..geometry.cameras import Fisheye62Camera, arctan_project, fisheye62_distort


def _sample_prep(height: int, width: int, coords: torch.Tensor):
    """Validity mask, integer floor cells and lerp weights.  A sample is
    valid only when its floor cell lies inside ``[0, W-2] x [0, H-2]``; the
    coordinates are clamped before the floor, so the weights follow the
    clamped value (NaN compares false and so is invalid)."""
    x = coords[..., 0]
    y = coords[..., 1]
    valid = (x >= 0) & (x < width - 1) & (y >= 0) & (y < height - 1)
    x = torch.clamp(x, 0.0, width - 2)
    y = torch.clamp(y, 0.0, height - 2)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return valid, x0.to(torch.int64), y0.to(torch.int64), x - x0, y - y0


def bilinear_sample_pool_plain(
    images: torch.Tensor,  # [M, H, W] uint8 or float32 image pool
    coords: torch.Tensor,  # [Wn, h, w, 2] per-warp (x, y) source coords
    src_idx: torch.Tensor,  # [Wn] pool index per warp
) -> torch.Tensor:  # [Wn, h, w] float32, on the pool's value scale
    """Bilinear sample of ``images[src_idx[k]]`` at ``coords[k]`` for every
    warp ``k``; samples outside ``[0, W-2] x [0, H-2]`` are 0."""
    m, h, w = images.shape
    valid, x0, y0, wx, wy = _sample_prep(h, w, coords.to(torch.float32))
    flat = images.reshape(-1)
    base = src_idx.to(torch.int64).reshape(-1, 1, 1) * (h * w) + y0 * w + x0
    # The clamp above keeps every tap inside its own image; this clamp only
    # keeps NaN-derived indices of invalid lanes addressable.
    base = torch.clamp(base, 0, m * h * w - w - 2)

    def tap(offset):
        return flat[base + offset].to(torch.float32)

    out = (
        tap(0) * (1 - wx) * (1 - wy)
        + tap(1) * wx * (1 - wy)
        + tap(w) * (1 - wx) * wy
        + tap(w + 1) * wx * wy
    )
    return torch.where(valid, out, torch.zeros_like(out))


def bilinear_sample_plain(
    image: torch.Tensor,  # [H, W] or [N, H, W] uint8 or float32
    coords: torch.Tensor,  # [..., 2] or [N, ..., 2] (x, y) source coords
) -> torch.Tensor:  # coords.shape[:-1] float32, on the image's value scale
    """Plain version of the single-image warp kernels: bilinear sample of
    the image (of image ``n`` at ``coords[n]`` when batched); samples
    outside ``[0, W-2] x [0, H-2]`` are 0."""
    images = image if image.dim() == 3 else image[None]
    n = images.shape[0]
    out = bilinear_sample_pool_plain(
        images, coords.reshape(n, 1, -1, 2),
        torch.arange(n, device=images.device),
    )
    return out.reshape(coords.shape[:-1])


def fisheye_to_pinhole_coords(
    dst_intrinsics: torch.Tensor,  # [..., 3, 3] crop pinhole K
    dst_T_world_from_eye: torch.Tensor,  # [..., 4, 4]
    src_cam: Fisheye62Camera,  # fields with the same batch dims
    out_size: Tuple[int, int],  # (height, width)
) -> torch.Tensor:  # [..., h, w, 2]
    """Source-pixel coordinate field for warping a fisheye view into a crop
    camera; pixels behind the source camera get coordinate -1."""
    h_out, w_out = out_size
    dtype, device = dst_T_world_from_eye.dtype, dst_T_world_from_eye.device
    py, px = torch.meshgrid(
        torch.arange(h_out, dtype=dtype, device=device),
        torch.arange(w_out, dtype=dtype, device=device),
        indexing="ij",
    )

    def per_pixel(a):  # [...] -> [..., 1, 1]
        return a[..., None, None]

    qx = (px - per_pixel(dst_intrinsics[..., 0, 2])) / per_pixel(dst_intrinsics[..., 0, 0])
    qy = (py - per_pixel(dst_intrinsics[..., 1, 2])) / per_pixel(dst_intrinsics[..., 1, 1])

    # Fold (normalize -> dst eye->world -> world->src eye) into one 3x3 plus
    # an offset scaled by |d|: with d = (qx, qy, 1),
    #   src_eye = (Rs^T Rd d + |d| * Rs^T (td - ts)) / |d|
    # and the equidistant projection is invariant under positive scaling,
    # so the division by |d| is dropped.
    t_src = src_cam.T_world_from_eye
    r_src_t = t_src[..., :3, :3].transpose(-1, -2)
    m = r_src_t @ dst_T_world_from_eye[..., :3, :3]
    b = (r_src_t @ (dst_T_world_from_eye[..., :3, 3] - t_src[..., :3, 3])[..., None])[..., 0]
    norm_d = torch.sqrt(qx * qx + qy * qy + 1.0)
    src_eye = torch.stack(
        [
            per_pixel(m[..., i, 0]) * qx + per_pixel(m[..., i, 1]) * qy
            + per_pixel(m[..., i, 2]) + norm_d * per_pixel(b[..., i])
            for i in range(3)
        ],
        dim=-1,
    )
    p = arctan_project(src_eye)
    q = fisheye62_distort(src_cam.coeffs[..., None, None, :], p)
    win = q * src_cam.f[..., None, None, :] + src_cam.c[..., None, None, :]
    invalid = src_eye[..., 2:3] < 0
    return torch.where(invalid, torch.full_like(win, -1.0), win)
