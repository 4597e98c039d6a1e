"""Host-side rules of the tiled warp kernels (``csrc/warp_common.cuh``).

The image-pool warp and the windowed single-image warp share one kernel
body: a block owns a rectangular tile of one crop's output pixels, every
thread owns ``PIXELS_PER_THREAD`` x-adjacent pixels of one row, and the
staged form copies the source box of a block's valid samples into a
``WIN_ROWS x WIN_COLS`` shared-memory window by 16-byte ``cp.async`` chunks.
What a launch looks like is decided here, from shapes and addresses alone,
by small pure functions that need no card:

- :func:`tiling`: the tile shape for a crop of ``h x w`` pixels;
- :func:`tile_pixel_map`: the kernel's index map (tile, thread, slot) ->
  output pixel, restated with numpy;
- :func:`io_path`: 16-byte vector loads and stores, or the scalar path;
- :func:`window_eligible`: whether the images can be staged at all;
- :func:`small_image`: images that the windowed wrapper sends to the full
  kernel;
- :func:`plan`: all of the above for one launch.

``CONSTANTS`` are the header's ``kPix``, ``kMaxThreads``, ``kWinRows`` and
``kWinCols``; :func:`check_constants` holds them against a library when it
loads.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

PIXELS_PER_THREAD = 4
MAX_THREADS = 256
# Threads of a block along x: 8 threads x 4 pixels make a tile 32 pixels wide.
TILE_THREADS_X = 8
# Threads per block.  With the taps read in place, 128 threads (a 16 x 32
# tile) measured 2-4 % faster than 256 on an H100; a staged block amortises
# its reduction and copy over 256 (a 32 x 32 tile), 10 % faster than 128.
THREADS_DIRECT = 128
THREADS_STAGED = 256
# The staged window in source pixels (rows x columns): a block copies
# exactly the box of its samples, so the window is sized for the widest box
# of the paths' 32 x 32 tiles (a 96 x 96 crop over a third of a 480 x 640
# frame: about 106 x 100 source pixels per tile, 131 x 130 at the 99th
# percentile, plus up to 15 pixels of alignment).
WIN_ROWS = 136
WIN_COLS = 160
CONSTANTS = (PIXELS_PER_THREAD, MAX_THREADS, WIN_ROWS, WIN_COLS)

VECTOR, SCALAR = "vector", "scalar"
STAGED_SUFFIX = "+cp_async"  # what a staged launch adds to its path's name
_VECTOR_BYTES = 16  # float4: two coordinate pairs in, four outputs out
_ALIGN = 16  # a staged image's base address and row pitch, in bytes


class Tiling(NamedTuple):
    """``threads`` per block, of which ``1 << log2_tx`` lie along x."""

    threads: int
    log2_tx: int

    @property
    def tile_h(self) -> int:
        return self.threads >> self.log2_tx

    @property
    def tile_w(self) -> int:
        return PIXELS_PER_THREAD << self.log2_tx


def tiling(h: int, w: int, staged: bool = False) -> Tiling:
    """The tile for a crop of ``h x w`` output pixels: ``THREADS_STAGED`` or
    ``THREADS_DIRECT`` threads, ``TILE_THREADS_X`` of them along x, or, for a
    crop shorter than that tile, as many rows as the next power of two above
    ``h`` and the rest of the block along x, so that a flat list (``h == 1``)
    is cut into rows of consecutive pixels and wastes no thread."""
    threads = THREADS_STAGED if staged else THREADS_DIRECT
    tile_h = 1
    while tile_h < min(h, threads // TILE_THREADS_X):
        tile_h *= 2
    return Tiling(threads, (threads // tile_h).bit_length() - 1)


def tile_counts(h: int, w: int, t: Tiling) -> Tuple[int, int]:
    """(tiles along y, tiles along x) that cover an ``h x w`` crop."""
    return -(-h // t.tile_h), -(-w // t.tile_w)


def tile_pixel_map(h: int, w: int, t: Tiling) -> np.ndarray:
    """``[tiles, threads, PIXELS_PER_THREAD]`` int64: the flat index
    ``y * w + x`` of the output pixel that each thread slot of each tile
    writes, -1 where the kernel masks the slot (past the crop's edge).
    Tiles run row-major, as ``blockIdx.x % tiles`` does in the kernel."""
    tiles_y, tiles_x = tile_counts(h, w, t)
    tile = np.arange(tiles_y * tiles_x)[:, None, None]
    thread = np.arange(t.threads)[None, :, None]
    slot = np.arange(PIXELS_PER_THREAD)[None, None, :]
    y = (tile // tiles_x) * t.tile_h + (thread >> t.log2_tx)
    x = (tile % tiles_x) * t.tile_w + (thread & ((1 << t.log2_tx) - 1)) * PIXELS_PER_THREAD + slot
    return np.where((y < h) & (x < w), y * w + x, -1).astype(np.int64)


def io_path(w: int, coords_ptr: int, out_ptr: int = 0) -> str:
    """``"vector"`` when every thread's four pixels can move as 16-byte
    words: the crop width is a multiple of ``PIXELS_PER_THREAD`` and both
    ``coords`` and ``out`` start on a 16-byte boundary.  Otherwise
    ``"scalar"`` (8-byte coordinate loads, 4-byte stores, each masked at the
    crop's edge), which needs ``coords`` on an 8-byte boundary and raises
    below that."""
    if coords_ptr % 8:
        raise ValueError("coords must be 8-byte aligned")
    vector = (w % PIXELS_PER_THREAD == 0 and coords_ptr % _VECTOR_BYTES == 0
              and out_ptr % _VECTOR_BYTES == 0)
    return VECTOR if vector else SCALAR


def window_eligible(w: int, itemsize: int, ptr: int) -> bool:
    """Whether images ``w`` elements of ``itemsize`` bytes wide at address
    ``ptr`` can be staged in shared memory: the 16-byte ``cp.async`` chunks
    need a 16-byte-aligned base and a row pitch that is a multiple of 16
    bytes.  Images that fail take the kernel's unstaged form (every tap read
    in place from global memory), never another function."""
    return ptr % _ALIGN == 0 and (w * itemsize) % _ALIGN == 0


def small_image(h: int, w: int) -> bool:
    """Images smaller than the staged window in either direction: the
    windowed wrapper hands them to the full kernel."""
    return h < WIN_ROWS or w < WIN_COLS


class Plan(NamedTuple):
    """One launch of the tiled kernel: ``vector`` I/O or scalar, ``staged``
    or every tap in place, the tile, and the name the launch is counted
    under: ``"vector"`` or ``"scalar"``, plus ``"+cp_async"`` when staged."""

    vector: bool
    staged: bool
    tiling: Tiling
    path: str


def plan(
    image_width: int,
    itemsize: int,
    images_ptr: int,
    crop: Tuple[int, int],  # (h, w) of one coordinate field
    coords_ptr: int,
    out_ptr: int,
    staged: bool,  # whether the kernel stages images that can be staged
) -> Plan:
    """Images that cannot be staged (:func:`window_eligible`) take the
    unstaged form whatever ``staged`` asks for, and the plan's ``path`` says
    so."""
    staged = staged and window_eligible(image_width, itemsize, images_ptr)
    io = io_path(crop[1], coords_ptr, out_ptr)
    return Plan(io == VECTOR, staged, tiling(*crop, staged=staged),
                io + (STAGED_SUFFIX if staged else ""))


def check_constants(lib_constant, source: str) -> None:
    """Raises unless the library's constants (``lib_constant(i)``, -1 past
    the last) are the ones stated here."""
    built = tuple(lib_constant(i) for i in range(len(CONSTANTS) + 1))
    if built != CONSTANTS + (-1,):
        raise RuntimeError(
            f"{source} was built with constants {built[:-1]}, the wrappers state {CONSTANTS}")
