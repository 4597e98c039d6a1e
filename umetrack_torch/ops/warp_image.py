"""Single-image bilinear warps: two hand-written CUDA kernels and their
wrappers.

They replace the two TPU kernels of ``umetrack_tpu/ops/pallas_resample.py``
that sample ONE image at a list of coordinates, and carry
``resample_images``, the image side of the torch_data path:

- :func:`warp_image_full` <- ``pallas_bilinear_sample``: one thread per
  sample, taps read in place, cost independent of where samples land;
- :func:`warp_image_windowed` <- ``pallas_bilinear_sample_windowed``: each
  block of 256 consecutive pixels stages the source box of its valid
  samples in a ``WIN_ROWS x WIN_COLS`` shared-memory window when the box
  fits, and reads its taps from global memory when it does not; the result
  is bit-identical either way.  An image smaller than the window goes to
  :func:`warp_image_full`, as the TPU wrapper sent it to the full-height
  kernel.

Both take ``image [H, W]`` with ``coords [..., 2]`` or a batch
``images [N, H, W]`` with ``coords [N, ..., 2]`` (image ``n`` sampled at
``coords[n]``) and make ONE launch per call whatever ``N`` is.  uint8 and
float32 images are read in place; a float image is sampled in f32 exactly
(the TPU float path rounded it to bf16), so for any content the kernels
agree with the gather samplers (``_bilinear_gather1d``).

The kernels are ``csrc/warp_image.cu``, built at first use and loaded with
``ctypes`` by ``ops/_build.py``.  CUDA tensors launch a kernel or raise; CPU
tensors take the plain version
(:func:`~umetrack_torch.ops.resample.bilinear_sample_plain`).  Each wrapper
counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .resample import bilinear_sample_plain

NAME = "warp_image"
# The windowed kernel's shared-memory window in source pixels; the same two
# constants as kWinRows / kWinCols of csrc/warp_image.cu (checked at load).
WIN_ROWS = 32
WIN_COLS = 384
_THREADS = 256
_MAX_BLOCKS = 2**31 - 1
_LAUNCH_ARGS = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
)
_SIGNATURES = {
    "warp_image_full_launch": _LAUNCH_ARGS,
    "warp_image_windowed_launch": _LAUNCH_ARGS,
    "warp_image_window_rows": (),
    "warp_image_window_cols": (),
}


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded library, its window checked against the wrapper's once."""
    lib = _build.library(NAME, _SIGNATURES)
    built = (lib.warp_image_window_rows(), lib.warp_image_window_cols())
    if built != (WIN_ROWS, WIN_COLS):
        raise RuntimeError(
            f"csrc/warp_image.cu was built with a {built} window, the wrapper "
            f"states {(WIN_ROWS, WIN_COLS)}"
        )
    return lib


def _check(image: torch.Tensor, coords: torch.Tensor) -> Tuple[int, int]:
    """Raises on what the kernels do not take; returns (N, pixels per image)."""
    if image.dim() not in (2, 3):
        raise ValueError(f"image must be [H, W] or [N, H, W], got {tuple(image.shape)}")
    if coords.dim() < 1 or coords.shape[-1] != 2:
        raise ValueError(f"coords must end in 2, got {tuple(coords.shape)}")
    if image.dim() == 3 and (coords.dim() < 2 or coords.shape[0] != image.shape[0]):
        raise ValueError(
            f"batched images {tuple(image.shape)} need coords [N, ..., 2] with "
            f"N={image.shape[0]}, got {tuple(coords.shape)}"
        )
    if image.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"image must be uint8 or float32, got {image.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if image.device != coords.device:
        raise ValueError(f"tensors on different devices: {image.device}, {coords.device}")
    if not (image.is_contiguous() and coords.is_contiguous()):
        raise ValueError("image and coords must be contiguous")
    h, w = image.shape[-2:]
    if h < 2 or w < 2:
        raise ValueError(f"image must be at least 2 x 2, got {h} x {w}")
    n = image.shape[0] if image.dim() == 3 else 1
    return n, coords.numel() // 2 // max(n, 1)


def _launch(fn_name: str, image: torch.Tensor, coords: torch.Tensor, n: int, pixels: int):
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    if n * -(-pixels // _THREADS) > _MAX_BLOCKS:
        raise ValueError(f"{n} images x {pixels} pixels exceed the kernel's grid")
    if coords.data_ptr() % 8:
        raise ValueError("coords must be 8-byte aligned")
    out = torch.empty(coords.shape[:-1], dtype=torch.float32, device=image.device)
    h, w = image.shape[-2:]
    lib = _library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = getattr(lib, fn_name)(
            image.data_ptr(), int(image.dtype == torch.float32),
            coords.data_ptr(), out.data_ptr(), n, pixels, h, w, stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
    return out


def warp_image_full(
    image: torch.Tensor,  # [H, W] or [N, H, W] uint8 or float32
    coords: torch.Tensor,  # [..., 2] or [N, ..., 2] float32 (x, y)
) -> torch.Tensor:  # coords.shape[:-1] float32 on the image's value scale
    """Bilinear sample of each image at its coordinates, 0 outside
    ``[0, W-2] x [0, H-2]``, every tap read from global memory.  CUDA
    tensors launch the kernel; CPU tensors take the plain version."""
    n, pixels = _check(image, coords)
    if image.device.type == "cpu":
        return bilinear_sample_plain(image, coords)
    out = _launch("warp_image_full_launch", image, coords, n, pixels)
    warp_image_full.launches += 1
    return out


def warp_image_windowed(
    image: torch.Tensor,  # [H, W] or [N, H, W] uint8 or float32
    coords: torch.Tensor,  # [..., 2] or [N, ..., 2] float32 (x, y)
) -> torch.Tensor:  # coords.shape[:-1] float32 on the image's value scale
    """The same function as :func:`warp_image_full`, bit for bit, with each
    block's source box staged in shared memory when it fits the window.  An
    image smaller than the window goes to :func:`warp_image_full`."""
    n, pixels = _check(image, coords)
    if image.device.type == "cpu":
        return bilinear_sample_plain(image, coords)
    h, w = image.shape[-2:]
    if h < WIN_ROWS or w < WIN_COLS:
        return warp_image_full(image, coords)
    out = _launch("warp_image_windowed_launch", image, coords, n, pixels)
    warp_image_windowed.launches += 1
    return out


warp_image_full.launches = 0
warp_image_windowed.launches = 0
