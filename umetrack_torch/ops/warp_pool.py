"""Image-pool bilinear warp: the hand-written CUDA kernel and its wrapper.

Replaces ``pallas_bilinear_sample_pool`` (``umetrack_tpu/ops/pallas_resample.py``),
the one TPU kernel on the tracker's main path: every warp of every frame in
one launch, each warp sampling its own image of the pool.  The kernel is
``csrc/warp_pool.cu`` (the tiled kernel of ``csrc/warp_common.cuh``), built
at first use and loaded with ``ctypes`` by ``ops/_build.py``.

:func:`warp_pool` launches the kernel for CUDA tensors and runs the plain
version (:func:`~umetrack_torch.ops.resample.bilinear_sample_pool_plain`)
for CPU tensors; ``warp_pool.launches`` counts kernel launches and
``warp_pool.paths`` counts them by the form of the kernel that ran
(``ops/_tiles.py`` holds the rules); both are incremented where the kernel
is launched (:func:`_launch`) and nowhere else, and a CUDA graph that
captured launches adds them on each replay (``tracker/compiled.py``).

On the CPU an ``src_idx`` outside the pool raises ``IndexError``; on the
card the range is checked by a device-side assert, with no host wait, and
an index outside the pool is a CUDA error at the next synchronisation.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import torch

from . import _build, _tiles
from .resample import bilinear_sample_pool_plain

NAME = "warp_pool"
_MAX_BLOCKS = 2**31 - 1
_SIGNATURES = {
    "warp_pool_launch": (
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ),
    "warp_pool_constant": (ctypes.c_int,),
}


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded library, its constants checked against ``_tiles`` once."""
    lib = _build.library(NAME, _SIGNATURES)
    _tiles.check_constants(lib.warp_pool_constant, "csrc/warp_pool.cu")
    return lib


def _check(images: torch.Tensor, coords: torch.Tensor, src_idx: torch.Tensor):
    if images.dim() != 3:
        raise ValueError(f"images must be [M, H, W], got {tuple(images.shape)}")
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be [Wn, h, w, 2], got {tuple(coords.shape)}")
    if src_idx.dim() != 1 or src_idx.shape[0] != coords.shape[0]:
        raise ValueError(
            f"src_idx must be [Wn] with Wn={coords.shape[0]}, got {tuple(src_idx.shape)}"
        )
    if images.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"images must be uint8 or float32, got {images.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if src_idx.dtype != torch.int32:
        raise TypeError(f"src_idx must be int32, got {src_idx.dtype}")
    if not (images.device == coords.device == src_idx.device):
        raise ValueError(
            f"tensors on different devices: {images.device}, {coords.device}, "
            f"{src_idx.device}"
        )
    if not (images.is_contiguous() and coords.is_contiguous() and src_idx.is_contiguous()):
        raise ValueError("images, coords and src_idx must be contiguous")
    m, h, w = images.shape
    if h < 2 or w < 2:
        raise ValueError(f"images must be at least 2 x 2, got {h} x {w}")
    if not src_idx.numel():
        return
    lo, hi = torch.aminmax(src_idx)
    if images.device.type == "cpu":
        if int(lo) < 0 or int(hi) >= m:
            raise IndexError(f"src_idx outside [0, {m})")
    else:
        # on the card the check stays there: no host wait (a CUDA graph can
        # capture it), and an index outside the pool fails the device-side
        # assert, a CUDA error at the next synchronisation
        torch._assert_async((lo >= 0) & (hi < m), f"src_idx outside [0, {m})")


def _launch(images: torch.Tensor, coords: torch.Tensor, src_idx: torch.Tensor) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors, counted in
    ``warp_pool.launches`` and ``warp_pool.paths``.  The pool's taps are
    read in place: the kernel has no staged form."""
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    wn, ch, cw = coords.shape[:3]
    out = torch.empty((wn, ch, cw), dtype=torch.float32, device=images.device)
    plan = _tiles.plan(
        images.shape[-1], images.element_size(), images.data_ptr(), (ch, cw),
        coords.data_ptr(), out.data_ptr(), staged=False,
    )
    tiles_y, tiles_x = _tiles.tile_counts(ch, cw, plan.tiling)
    if wn * tiles_y * tiles_x > _MAX_BLOCKS:
        raise ValueError(f"{wn} warps of {ch} x {cw} pixels exceed the kernel's grid")
    h, w = images.shape[-2:]
    lib = _library()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = lib.warp_pool_launch(
            images.data_ptr(), int(images.dtype == torch.float32),
            coords.data_ptr(), src_idx.data_ptr(), out.data_ptr(),
            wn, ch, cw, h, w, int(plan.vector),
            plan.tiling.threads, plan.tiling.log2_tx, stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_pool kernel launch failed ({plan.path}): CUDA error {err}")
    warp_pool.launches += 1
    warp_pool.paths[plan.path] += 1
    return out


def warp_pool(
    images: torch.Tensor,  # [M, H, W] uint8 or float32 image pool
    coords: torch.Tensor,  # [Wn, h, w, 2] float32 per-warp (x, y)
    src_idx: torch.Tensor,  # [Wn] int32 pool index per warp
) -> torch.Tensor:  # [Wn, h, w] float32 on the pool's value scale
    """Bilinear sample of ``images[src_idx[k]]`` at ``coords[k]`` for every
    warp, 0 outside ``[0, W-2] x [0, H-2]``.  CUDA tensors launch the kernel;
    CPU tensors take the plain version.

    The kernel moves four pixels per thread as 16-byte words (path
    ``"vector"``) when ``w % 4 == 0`` and ``coords`` is 16-byte aligned, and
    takes the ``"scalar"`` path otherwise; ``coords`` that is not 8-byte
    aligned raises.  ``warp_pool.paths`` counts the launches of each."""
    _check(images, coords, src_idx)
    if images.device.type == "cpu":
        return bilinear_sample_pool_plain(images, coords, src_idx)
    return _launch(images, coords, src_idx)


warp_pool.launches = 0
warp_pool.paths = collections.Counter()
