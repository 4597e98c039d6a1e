"""Port parity: the warp front end (``fisheye_to_pinhole_coords``) and the
image-pool sampler's plain version against the JAX package's pool kernel
(interpret mode) and gather sampler, plus the kernel wrapper's checks."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from umetrack_tpu.geometry.cameras import Fisheye62Camera as JCam
from umetrack_tpu.ops import resample as jresample
from umetrack_tpu.ops.pallas_resample import pallas_bilinear_sample_pool
from umetrack_torch.geometry.cameras import Fisheye62Camera
from umetrack_torch.ops import bilinear_sample_pool_plain, fisheye_to_pinhole_coords, warp_pool

# the JAX tests' bound on the 0-255 scale (tests/test_pallas_resample.py:191)
ATOL = 2e-2


def _gather_ref(pool, coords, src_idx):
    return np.stack([
        np.asarray(jresample.bilinear_sample(
            jnp.asarray(pool[s]), jnp.asarray(c), "gather1d"))
        for c, s in zip(coords, src_idx)
    ])


def _pool_ref(pool, coords, src_idx):
    return np.asarray(pallas_bilinear_sample_pool(
        jnp.asarray(pool), jnp.asarray(coords), jnp.asarray(src_idx), interpret=True,
    ))


def _plain(pool, coords, src_idx):
    return bilinear_sample_pool_plain(
        torch.from_numpy(pool), torch.from_numpy(coords), torch.from_numpy(src_idx)
    ).numpy()


def test_fisheye_to_pinhole_coords_matches_jax():
    k = np.asarray([[120.0, 0, 47.5], [0, 120.0, 47.5], [0, 0, 1]], np.float32)
    cos, sin = np.cos(0.15), np.sin(0.15)
    dst = np.eye(4, dtype=np.float32)
    dst[:3, :3] = [[cos, 0, sin], [0, 1, 0], [-sin, 0, cos]]  # crop camera yawed 0.15 rad
    dst[:3, 3] = [40.0, -30.0, -380.0]
    src = np.eye(4, dtype=np.float32)
    src[:3, 3] = [-120.0, -60.0, -430.0]
    behind = np.eye(4, dtype=np.float32)  # in front of the crop camera, facing away
    behind[:3, 3] = [40.0, -30.0, -200.0]
    coeffs = np.asarray([0.35, 0.27, -0.5, 0.4, 1e-4, -2e-4, 0.0, 0.0], np.float32)
    fields = dict(fx=275.0, fy=275.0, cx=319.5, cy=239.5, width=640.0, height=480.0)
    cams = [
        Fisheye62Camera(**{n: torch.tensor(v) for n, v in fields.items()},
                        T_world_from_eye=torch.from_numpy(t), coeffs=torch.from_numpy(coeffs))
        for t in (src, behind)
    ]
    jcams = [
        JCam(**{n: jnp.asarray(v, jnp.float32) for n, v in fields.items()},
             T_world_from_eye=jnp.asarray(t), coeffs=jnp.asarray(coeffs))
        for t in (src, behind)
    ]
    for cam, jcam in zip(cams, jcams):  # the second sees the crop behind it: -1
        ours = fisheye_to_pinhole_coords(torch.from_numpy(k), torch.from_numpy(dst), cam, (96, 96))
        ref = np.asarray(jresample.fisheye_to_pinhole_coords(
            jnp.asarray(k), jnp.asarray(dst), jcam, (96, 96)))
        assert ours.shape == (96, 96, 2)
        np.testing.assert_array_equal(ours.numpy() == -1.0, ref == -1.0)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-3, rtol=1e-5)
    assert (ours.numpy() == -1.0).any()


def _pool_cases():
    """The warps of tests/test_pallas_resample.py:151-192: rotated/scaled
    grids with duplicated and skipped sources, and a scattered warp with
    out-of-bounds coordinates."""
    rng = np.random.default_rng(5)
    pool = rng.integers(0, 255, size=(4, 480, 640)).astype(np.float32)
    gy, gx = np.mgrid[0:96, 0:96].astype(np.float32)
    warps, srcs = [], []
    for i, (ang, scale, ox, oy) in enumerate([
        (0.2, 2.2, 250.0, 120.0), (-0.3, 1.8, 300.0, 200.0), (0.05, 2.5, 100.0, 60.0),
        (0.4, 2.0, 400.0, 250.0), (0.0, 2.1, 240.0, 130.0),
    ]):
        sx = scale * (np.cos(ang) * gx - np.sin(ang) * gy) + ox
        sy = scale * (np.sin(ang) * gx + np.cos(ang) * gy) + oy
        warps.append(np.stack([sx, sy], axis=-1))
        srcs.append(i % 3)
    warps.append(rng.uniform(-10, 650, size=(96, 96, 2)).astype(np.float32))
    srcs.append(3)
    return pool, np.stack(warps).astype(np.float32), np.asarray(srcs, np.int32)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_pool_plain_matches_jax_pool_kernel_and_gather(dtype):
    pool, coords, src_idx = _pool_cases()
    pool = pool.astype(dtype)
    ours = _plain(pool, coords, src_idx)
    np.testing.assert_allclose(ours, _gather_ref(pool, coords, src_idx), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(ours, _pool_ref(pool, coords, src_idx), atol=ATOL, rtol=1e-5)


def test_pool_plain_nonmultiple_shape_and_edges():
    """Per-warp shapes that fill no block evenly (tests/test_pallas_resample.py
    :194-215), plus -1, NaN and the exact W-1 / H-1 edges (invalid) and the
    last valid cell."""
    rng = np.random.default_rng(6)
    pool = rng.integers(0, 255, size=(2, 200, 300)).astype(np.uint8)
    coords = rng.uniform(0, 190, size=(3, 40, 50, 2)).astype(np.float32)
    coords[0, 0, :6] = [[-1, -1], [np.nan, 5], [299, 10], [10, 199], [298.5, 198.5], [0, 0]]
    src_idx = np.asarray([1, 0, 1], np.int32)
    ours = _plain(pool, coords, src_idx)
    assert ours.shape == (3, 40, 50)
    np.testing.assert_array_equal(ours[0, 0, :4], 0.0)
    np.testing.assert_allclose(ours, _gather_ref(pool, coords, src_idx), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(ours, _pool_ref(pool, coords, src_idx), atol=ATOL, rtol=1e-5)


def test_warp_pool_wrapper_checks():
    pool = torch.zeros((2, 20, 30), dtype=torch.uint8)
    coords = torch.zeros((3, 4, 5, 2))
    good = torch.tensor([0, 1, 1], dtype=torch.int32)
    assert warp_pool(pool, coords, good).shape == (3, 4, 5)
    with pytest.raises(IndexError):
        warp_pool(pool, coords, torch.tensor([0, 2, 1], dtype=torch.int32))
    with pytest.raises(IndexError):
        warp_pool(pool, coords, torch.tensor([0, -1, 1], dtype=torch.int32))
    with pytest.raises(TypeError):
        warp_pool(pool.to(torch.int16), coords, good)
    with pytest.raises(TypeError):
        warp_pool(pool, coords.double(), good)
    with pytest.raises(TypeError):
        warp_pool(pool, coords, good.long())
    with pytest.raises(ValueError):
        warp_pool(pool, coords[:2], good)
    with pytest.raises(ValueError):
        warp_pool(pool.transpose(1, 2), coords, good)


def test_grid_sample_is_not_the_pool_warp():
    """Why the kernels' ``library_ms`` is null: ``grid_sample`` (5-D, the
    depth picking each warp's pool image, bilinear, zero padding) agrees
    with the pool warp's plain version inside the valid cells, but not in
    the last column and row band, where the warp clamps the floor to W-2 /
    H-2 and takes that column or row alone, nor outside, where the warp
    gives 0 and ``grid_sample`` blends the border pixels with zeros."""
    rng = np.random.default_rng(3)
    m, h, w = 4, 48, 64
    pool = rng.integers(0, 256, (m, h, w), dtype=np.uint8)
    coords = (rng.uniform(-2.0, 1.0, (6, 24, 32, 2)) * [w + 2, h + 2] + [w, h]).astype(np.float32)
    src = rng.integers(0, m, 6).astype(np.int32)
    ours = _plain(pool, coords, src)
    grid = torch.from_numpy(coords) * torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)]) - 1.0
    z = (2.0 * torch.from_numpy(src).float() / (m - 1) - 1.0).view(-1, 1, 1, 1).expand(*grid.shape[:-1], 1)
    lib = torch.nn.functional.grid_sample(torch.from_numpy(pool).float()[None, None],
                                          torch.cat([grid, z], dim=-1)[None], mode="bilinear",
                                          padding_mode="zeros", align_corners=True)[0, 0].numpy()
    x, y = coords[..., 0], coords[..., 1]
    inside = (x >= 0) & (x < w - 2) & (y >= 0) & (y < h - 2)
    band = ((x > w - 2) & (x < w - 1) & (y >= 0) & (y < h - 2)) | ((y > h - 2) & (y < h - 1) & (x >= 0) & (x < w - 2))
    outside = ((x < -0.5) | (y < -0.5)) & (x > -1) & (y > -1)
    assert inside.any() and band.any() and outside.any()
    np.testing.assert_allclose(lib[inside], ours[inside], atol=ATOL)
    assert (np.abs(lib[band] - ours[band]) > 1.0).any()
    assert (ours[outside] == 0).all() and (lib[outside] != 0).any()
