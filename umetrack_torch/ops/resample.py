"""Image warping: coordinate fields, the samplers and their plain versions.

Counterpart of ``umetrack_tpu/ops/resample.py``:

- :func:`resample_images` is the dst-pixel homography warp of the
  torch_data path: homography -> coordinates -> one batched sampler call;
- :func:`fisheye_to_pinhole_coords` is the per-pixel unproject (pinhole
  crop) -> world -> project (fisheye) field, batched over any leading dims,
  and :func:`warp_fisheye_to_pinhole` samples one view through it;
- :func:`bilinear_sample` picks the sampler (table in its docstring);
- :func:`bilinear_sample_plain` and :func:`bilinear_sample_pool_plain` are
  the plain PyTorch versions of the CUDA kernels (``ops/warp_image.py``,
  ``ops/warp_pool.py``): the 4-tap flat gather of ``_bilinear_gather1d``
  with the shared ``_sample_prep`` rule.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


SAMPLERS = ("plain", "kernel_full", "kernel_win")


def default_sampler(device=None) -> str:
    """The sampler :func:`bilinear_sample` takes for tensors on ``device``:
    ``kernel_win`` on CUDA, ``plain`` on the CPU.  ``None`` names the
    device this process would run on (CUDA when there is a card)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return "kernel_win" if torch.device(device).type == "cuda" else "plain"


def bilinear_sample(
    image: torch.Tensor,  # [H, W] or [N, H, W] uint8 or float32
    coords: torch.Tensor,  # [..., 2] or [N, ..., 2] float32 (x, y)
    method: Optional[str] = None,
) -> torch.Tensor:  # coords.shape[:-1] float32
    """Bilinear sampling with zero outside ``[0, W-2] x [0, H-2]``: a sample
    is valid only when its floor cell has all four neighbours inside the
    image.  The samplers, beside the JAX package's names for them:

    ===============  ======================================================
    ``method``       ``umetrack_tpu`` sampler
    ===============  ======================================================
    ``plain``        ``gather1d`` (and ``gather2d``, the same gather
                     indexed in two dimensions)
    ``kernel_full``  ``pallas`` (and ``matmul``, its form outside Pallas)
    ``kernel_win``   ``pallas_win``, ``pallas_win2``, ``pallas_win_cm``
                     (tile shapes of the one windowed TPU kernel)
    ===============  ======================================================

    ``None`` takes ``kernel_win`` for CUDA tensors and ``plain`` for CPU
    tensors; a kernel name with a CPU tensor raises."""
    from .warp_image import warp_image_full, warp_image_windowed

    on_cuda = image.device.type == "cuda"
    name = method or default_sampler(image.device)
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}: use one of {SAMPLERS}")
    if name == "plain":
        return bilinear_sample_plain(image, coords)
    if not on_cuda:
        raise ValueError(f"sampler {name!r} needs CUDA tensors; use 'plain' on the CPU")
    kernel = warp_image_windowed if name == "kernel_win" else warp_image_full
    return kernel(image, coords)


def homography_coords(
    resample_xfs: torch.Tensor,  # [N, 4, 4] dst-pixel -> src-pixel homography
    out_size: Tuple[int, int],  # (height, width)
) -> torch.Tensor:  # [N, h, w, 2] float32 source (x, y) per dst pixel
    """Source-pixel coordinate fields of per-image pixel homographies, which
    take homogeneous dst pixels (u, v, 1) to src pixels."""
    h_out, w_out = out_size
    dtype, device = resample_xfs.dtype, resample_xfs.device
    py, px = torch.meshgrid(
        torch.arange(h_out, dtype=dtype, device=device),
        torch.arange(w_out, dtype=dtype, device=device),
        indexing="ij",
    )
    grid = torch.stack([px, py, torch.ones_like(px)], dim=-1)  # [h, w, 3]
    r = resample_xfs[:, 0:3, 0:3]
    t = resample_xfs[:, 0:3, 3]
    pts = torch.einsum("nij,hwj->nhwi", r, grid) + t[:, None, None, :]
    return (pts[..., 0:2] / pts[..., 2:3]).to(torch.float32).contiguous()


def resample_images(
    images: torch.Tensor,  # [N, H, W] uint8 or float32
    resample_xfs: torch.Tensor,  # [N, 4, 4] dst-pixel -> src-pixel homography
    out_size: Tuple[int, int],  # (height, width)
    method: Optional[str] = None,
) -> torch.Tensor:  # [N, h, w] float32 on the images' value scale
    """Warp ``images`` through per-image pixel homographies (the
    K_src @ E_src @ E_dst^-1 @ K_dst^-1 chain of the crop math): one
    sampler call for all N images."""
    coords = homography_coords(resample_xfs, out_size)
    return bilinear_sample(images.contiguous(), coords, method)


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


def warp_fisheye_to_pinhole(
    image: torch.Tensor,  # [H, W] or [N, H, W]
    dst_intrinsics: torch.Tensor,  # [3, 3] or [N, 3, 3]
    dst_T_world_from_eye: torch.Tensor,  # [4, 4] or [N, 4, 4]
    src_cam: Fisheye62Camera,  # fields with the same batch dims
    out_size: Tuple[int, int],
    method: Optional[str] = None,
) -> torch.Tensor:  # [h, w] or [N, h, w]
    """Warp fisheye views into their crop cameras (one sampler call)."""
    coords = fisheye_to_pinhole_coords(dst_intrinsics, dst_T_world_from_eye, src_cam, out_size)
    return bilinear_sample(image.contiguous(), coords.to(torch.float32).contiguous(), method)
