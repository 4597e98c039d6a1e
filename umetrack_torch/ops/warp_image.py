"""Single-image bilinear warps: two hand-written CUDA kernels and their
wrappers.

They replace the two TPU kernels of ``umetrack_tpu/ops/pallas_resample.py``
that sample ONE image at a list of coordinates, and carry
``resample_images``, the image side of the torch_data path:

- :func:`warp_image_full` <- ``pallas_bilinear_sample``: one thread per
  sample, taps read in place, cost independent of where samples land;
- :func:`warp_image_windowed` <- ``pallas_bilinear_sample_windowed``: each
  block takes a 2-D tile of one coordinate field, four x-adjacent pixels per
  thread, and copies the source box of its valid samples asynchronously
  into a ``WIN_ROWS x WIN_COLS`` shared-memory window when the box fits,
  reading its taps from global memory when it does not; the result is
  bit-identical either way.  An image smaller than the window goes to
  :func:`warp_image_full`, as the TPU wrapper sent it to the full-height
  kernel.

Both take ``image [H, W]`` with ``coords [..., 2]`` or a batch
``images [N, H, W]`` with ``coords [N, ..., 2]`` (image ``n`` sampled at
``coords[n]``) and make ONE launch per call whatever ``N`` is.  uint8 and
float32 images are read in place; a float image is sampled in f32 exactly
(the TPU float path rounded it to bf16), so for any content the kernels
agree with the gather samplers (``_bilinear_gather1d``).

The kernels are ``csrc/warp_image.cu`` (the windowed one is the tiled
kernel of ``csrc/warp_common.cuh``), built at first use and loaded with
``ctypes`` by ``ops/_build.py``.  CUDA tensors launch a kernel or raise; CPU
tensors take the plain version
(:func:`~umetrack_torch.ops.resample.bilinear_sample_plain`).  Each wrapper
counts its launches in ``.launches``; the windowed one also counts them by
the form of the kernel that ran in ``.paths`` (``ops/_tiles.py`` holds the
rules).  The counts are incremented where a kernel is launched
(:func:`_launch_full`, :func:`_launch_windowed`) and nowhere else, and a
CUDA graph that captured launches adds them on each replay
(``tracker/compiled.py``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Tuple

import torch

from . import _build, _tiles
from .resample import bilinear_sample_plain

NAME = "warp_image"
# The windowed kernel's shared-memory window in source pixels; the same two
# constants as kWinRows / kWinCols of csrc/warp_common.cuh (checked at load).
WIN_ROWS = _tiles.WIN_ROWS
WIN_COLS = _tiles.WIN_COLS
_THREADS = 256  # the full kernel's block
_MAX_BLOCKS = 2**31 - 1
_SIGNATURES = {
    "warp_image_full_launch": (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ),
    "warp_image_windowed_launch": (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ),
    "warp_image_constant": (ctypes.c_int,),
}


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded library, its constants checked against ``_tiles`` once."""
    lib = _build.library(NAME, _SIGNATURES)
    _tiles.check_constants(lib.warp_image_constant, "csrc/warp_image.cu")
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


def _crop_shape(image: torch.Tensor, coords: torch.Tensor) -> Tuple[int, int]:
    """(h, w) of the coordinate field of one image, as the tiled kernel cuts
    it: the last list dimension is a row, all before it are stacked rows; a
    flat list is one row."""
    dims = coords.shape[1:-1] if image.dim() == 3 else coords.shape[:-1]
    if len(dims) == 0:
        return 1, 1
    return dims[:-1].numel(), dims[-1]


def _launch_full(image: torch.Tensor, coords: torch.Tensor, n: int, pixels: int) -> torch.Tensor:
    """One launch of the full kernel on checked CUDA tensors, counted in
    ``warp_image_full.launches``."""
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
        err = lib.warp_image_full_launch(
            image.data_ptr(), int(image.dtype == torch.float32),
            coords.data_ptr(), out.data_ptr(), n, pixels, h, w, stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_image_full_launch failed: CUDA error {err}")
    warp_image_full.launches += 1
    return out


def _launch_windowed(image: torch.Tensor, coords: torch.Tensor, n: int) -> torch.Tensor:
    """One launch of the tiled kernel on checked CUDA tensors, counted in
    ``warp_image_windowed.launches`` and ``.paths``."""
    if image.device.type != "cuda":
        raise ValueError(f"unsupported device {image.device}")
    h, w = image.shape[-2:]
    ch, cw = _crop_shape(image, coords)
    out = torch.empty(coords.shape[:-1], dtype=torch.float32, device=image.device)
    plan = _tiles.plan(
        w, image.element_size(), image.data_ptr(), (ch, cw),
        coords.data_ptr(), out.data_ptr(), staged=True,
    )
    tiles_y, tiles_x = _tiles.tile_counts(ch, cw, plan.tiling)
    if n * tiles_y * tiles_x > _MAX_BLOCKS:
        raise ValueError(f"{n} fields of {ch} x {cw} pixels exceed the kernel's grid")
    lib = _library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = lib.warp_image_windowed_launch(
            image.data_ptr(), int(image.dtype == torch.float32),
            coords.data_ptr(), out.data_ptr(), n, ch, cw, h, w,
            int(plan.vector), int(plan.staged),
            plan.tiling.threads, plan.tiling.log2_tx, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"warp_image_windowed_launch failed ({plan.path}): CUDA error {err}")
    warp_image_windowed.launches += 1
    warp_image_windowed.paths[plan.path] += 1
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
    return _launch_full(image, coords, n, pixels)


def warp_image_windowed(
    image: torch.Tensor,  # [H, W] or [N, H, W] uint8 or float32
    coords: torch.Tensor,  # [..., 2] or [N, ..., 2] float32 (x, y)
) -> torch.Tensor:  # coords.shape[:-1] float32 on the image's value scale
    """The same function as :func:`warp_image_full`, bit for bit, with each
    block's source box staged in shared memory when it fits the window.

    An image smaller than the ``WIN_ROWS x WIN_COLS`` window in either
    direction goes to :func:`warp_image_full`.  Otherwise the tiled kernel
    runs: with 16-byte loads and stores (path ``"vector"``) when the last
    list dimension is a multiple of 4 and ``coords`` is 16-byte aligned,
    ``"scalar"`` otherwise (``coords`` that is not 8-byte aligned raises);
    staged (``"+cp_async"``) when the images start on a 16-byte boundary
    and their row pitch is a multiple of 16 bytes, every tap in place when
    not.  ``warp_image_windowed.paths`` counts the launches of each.

    On an H100 the staged window does not pay: at the torch_data shape this
    kernel is a few percent slower than :func:`warp_image_full` and than its
    own unstaged form (``PERF.md``).  It is kept staged because the window
    is what tells it from the full kernel, as it tells the TPU pair apart."""
    n, _ = _check(image, coords)
    if image.device.type == "cpu":
        return bilinear_sample_plain(image, coords)
    if _tiles.small_image(*image.shape[-2:]):
        return warp_image_full(image, coords)
    return _launch_windowed(image, coords, n)


warp_image_full.launches = 0
warp_image_windowed.launches = 0
warp_image_windowed.paths = collections.Counter()
