"""Port parity for the single-image samplers: ``bilinear_sample_plain`` (the
plain version of the two CUDA kernels of ``ops/warp_image.py``) against the
JAX gather sampler and against both single-image Pallas kernels in
interpret mode; ``resample_images`` against the JAX one; and the wrappers'
checks and dispatch."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from umetrack_tpu.ops import resample as jresample
from umetrack_tpu.ops.pallas_resample import (
    pallas_bilinear_sample,
    pallas_bilinear_sample_windowed,
)
from umetrack_torch.ops import (
    bilinear_sample,
    bilinear_sample_plain,
    resample_images,
    warp_image_full,
    warp_image_windowed,
)
from umetrack_torch.ops import warp_image as warp_image_module

# the gather samplers do the same f32 arithmetic: rounding only
GATHER_ATOL = 1e-4
# the JAX tests' bound for the kernels on the 0-255 scale
# (tests/test_pallas_resample.py:191)
KERNEL_ATOL = 2e-2


def _plain(image, coords):
    return bilinear_sample_plain(torch.from_numpy(image), torch.from_numpy(coords)).numpy()


def _gather(image, coords):
    return np.asarray(jresample._bilinear_gather1d(
        jnp.asarray(image).astype(jnp.float32), jnp.asarray(coords)))


def _case(name):
    """(image [H, W] f32 with 0..255 integer content, coords [..., 2])."""
    rng = np.random.default_rng(11)
    if name == "scattered":  # out-of-bounds samples all around a 480 x 640 image
        img = rng.integers(0, 255, size=(480, 640))
        coords = rng.uniform(-10, 650, size=(96, 96, 2))
    elif name == "grid":  # a rotated, scaled crop grid: coherent blocks
        img = rng.integers(0, 255, size=(480, 640))
        gy, gx = np.mgrid[0:96, 0:96].astype(np.float32)
        coords = np.stack([
            2.2 * (np.cos(0.2) * gx - np.sin(0.2) * gy) + 250.0,
            2.2 * (np.sin(0.2) * gx + np.cos(0.2) * gy) + 120.0,
        ], axis=-1)
    elif name == "small":  # smaller than any window: the full-height path
        img = rng.integers(0, 255, size=(120, 160))
        coords = rng.uniform(-5, 165, size=(40, 50, 2))
    elif name == "flat":  # a flat list, no multiple of any block
        img = rng.integers(0, 255, size=(200, 300))
        coords = rng.uniform(-3, 303, size=(1001, 2))
    elif name == "edges":
        img = rng.integers(0, 255, size=(200, 300))
        coords = rng.uniform(0, 190, size=(7, 11, 2))
        coords[0, :11] = [
            [-1, -1], [np.nan, 5], [5, np.nan], [np.inf, 3], [-np.inf, 3], [299, 10],
            [10, 199], [298.5, 198.5], [298.999, 198.999], [0, 0], [-0.001, 3],
        ]
    return img.astype(np.float32), coords.astype(np.float32)


CASES = ["scattered", "grid", "small", "flat", "edges"]


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_gather(name, dtype):
    img, coords = _case(name)
    ours = _plain(img.astype(dtype), coords)
    assert ours.shape == coords.shape[:-1] and ours.dtype == np.float32
    np.testing.assert_allclose(ours, _gather(img.astype(dtype), coords), atol=GATHER_ATOL, rtol=0)


@pytest.mark.parametrize("kernel", [pallas_bilinear_sample, pallas_bilinear_sample_windowed],
                         ids=["full_height", "windowed"])
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_pallas_kernels(name, kernel):
    img, coords = _case(name)
    ref = np.asarray(kernel(jnp.asarray(img), jnp.asarray(coords), interpret=True))
    np.testing.assert_allclose(_plain(img, coords), ref, atol=KERNEL_ATOL, rtol=1e-5)


def test_plain_edge_values():
    """-1, NaN, inf, W-1 and H-1 exactly are invalid (0); the origin is
    sampled, and a coordinate in (W-2, W-1) is valid and, clamped before the
    floor, samples cell W-2 with weight 0 on W-1."""
    img, coords = _case("edges")
    out = _plain(img, coords)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[0, [0, 1, 2, 3, 4, 5, 6, 10]], 0.0)
    assert out[0, 9] == img[0, 0]
    assert out[0, 7] == img[198, 298] and out[0, 8] == img[198, 298]


def test_plain_fractional_content_is_sampled_in_f32():
    """Non-integer float content: the port samples f32 exactly like the
    gather, where the TPU float path rounds the image to bf16."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, size=(64, 96)).astype(np.float32)
    coords = rng.uniform(-2, 97, size=(333, 2)).astype(np.float32)
    np.testing.assert_allclose(_plain(img, coords), _gather(img, coords), atol=GATHER_ATOL, rtol=0)


def test_batched_equals_per_image():
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 255, size=(3, 60, 80)).astype(np.uint8)
    coords = rng.uniform(-4, 84, size=(3, 9, 13, 2)).astype(np.float32)
    batched = _plain(imgs, coords)
    assert batched.shape == (3, 9, 13)
    for n in range(3):
        np.testing.assert_array_equal(batched[n], _plain(imgs[n], coords[n]))
        np.testing.assert_allclose(batched[n], _gather(imgs[n], coords[n]), atol=GATHER_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_resample_images_matches_jax(dtype):
    rng = np.random.default_rng(5)
    base = rng.uniform(20, 230, size=(3, 12, 16)).astype(np.float32)
    imgs = np.kron(base, np.ones((10, 10), np.float32)).astype(dtype)  # [3, 120, 160]
    xfs = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for n, (ang, s, ox, oy) in enumerate([(0.1, 1.2, 20.0, 5.0), (-0.2, 0.9, 40.0, 30.0), (0.0, 2.0, -10.0, -8.0)]):
        xfs[n, :2, :2] = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
        xfs[n, :2, 3] = [ox, oy]
        xfs[n, 2, 0] = 1e-4 * n  # a little perspective
    ours = resample_images(torch.from_numpy(imgs), torch.from_numpy(xfs), (96, 96)).numpy()
    ref = np.asarray(jresample.resample_images(
        jnp.asarray(imgs).astype(jnp.float32), jnp.asarray(xfs), (96, 96)))
    assert ours.shape == (3, 96, 96)
    assert (ours == 0).any() and (ours != 0).any()
    np.testing.assert_allclose(ours, ref, atol=KERNEL_ATOL, rtol=0)


def test_sampler_names():
    img = torch.zeros((20, 30), dtype=torch.uint8)
    coords = torch.zeros((4, 2))
    assert bilinear_sample(img, coords).shape == (4,)  # CPU default: plain
    assert bilinear_sample(img, coords, "plain").shape == (4,)
    for name in ("kernel_win", "kernel_full"):
        with pytest.raises(ValueError, match="CUDA"):
            bilinear_sample(img, coords, name)
    with pytest.raises(ValueError, match="unknown sampler"):
        bilinear_sample(img, coords, "pallas_win")


@pytest.mark.parametrize("wrapper", [warp_image_full, warp_image_windowed])
def test_wrapper_checks(wrapper):
    img = torch.zeros((2, 20, 30), dtype=torch.uint8)
    coords = torch.zeros((2, 4, 5, 2))
    assert wrapper(img, coords).shape == (2, 4, 5)
    assert wrapper(img[0], coords).shape == (2, 4, 5)  # one image, any list
    with pytest.raises(TypeError):
        wrapper(img.to(torch.int16), coords)
    with pytest.raises(TypeError):
        wrapper(img, coords.double())
    with pytest.raises(ValueError):
        wrapper(img, coords[:1])  # batch sizes differ
    with pytest.raises(ValueError):
        wrapper(img, coords[..., :1])
    with pytest.raises(ValueError):
        wrapper(img.transpose(1, 2), coords)
    with pytest.raises(ValueError):
        wrapper(torch.zeros((2, 1, 30), dtype=torch.uint8), coords)
    with pytest.raises(ValueError):
        wrapper(torch.zeros((1, 2, 20, 30), dtype=torch.uint8), coords)


def test_window_constants_send_small_images_to_the_full_kernel():
    """The dispatch rule the card run checks with launch counters: the
    repository's 120 x 160 corpus is smaller than the window, 480 x 640
    frames are not."""
    rows, cols = warp_image_module.WIN_ROWS, warp_image_module.WIN_COLS
    assert 120 < rows or 160 < cols
    assert 480 >= rows and 640 >= cols
