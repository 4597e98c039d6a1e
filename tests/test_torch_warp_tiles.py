"""The host-side rules of the tiled warp kernels (``umetrack_torch/ops/_tiles.py``)
and the wrappers' checks, on the CPU: the kernels' index map covers every
output pixel exactly once, the vector / scalar and staged / direct path
rules, the small-image rule, the build key, and what the wrappers refuse.

``_tiles.tile_pixel_map`` restates the kernel's index arithmetic with numpy,
so the map test holds the rule and not the CUDA source: the kernel itself is
held on the card by ``chip_smoke.py``, which compares its output with the
plain version bit for bit at every crop shape listed here."""
import importlib

import numpy as np
import pytest
import torch

from umetrack_torch.ops import _build, _tiles, warp_image_full, warp_image_windowed, warp_pool
from umetrack_torch.ops import warp_image as warp_image_module

# ``umetrack_torch.ops.warp_pool`` names the function; this is its module
warp_pool_module = importlib.import_module("umetrack_torch.ops.warp_pool")

CROPS = [(96, 96), (7, 11), (97, 95), (1, 1001)]
# the rule's two tiles, and others the launcher accepts (64, 128 or 256 threads)
TILINGS = [None, "staged", _tiles.Tiling(256, 2), _tiles.Tiling(256, 8), _tiles.Tiling(128, 3), _tiles.Tiling(64, 2)]


@pytest.mark.parametrize("h,w", CROPS)
@pytest.mark.parametrize("tile", TILINGS)
def test_tile_map_covers_every_pixel_once(h, w, tile):
    if not isinstance(tile, _tiles.Tiling):
        tile = _tiles.tiling(h, w, staged=tile == "staged")
    pixel = _tiles.tile_pixel_map(h, w, tile)
    tiles_y, tiles_x = _tiles.tile_counts(h, w, tile)
    assert pixel.shape == (tiles_y * tiles_x, tile.threads, _tiles.PIXELS_PER_THREAD)
    live = pixel[pixel >= 0]
    np.testing.assert_array_equal(np.sort(live), np.arange(h * w))
    # a thread's pixels are x-adjacent in one row, which the 16-byte I/O needs
    first = pixel[..., 0]
    for k in range(1, _tiles.PIXELS_PER_THREAD):
        nxt = pixel[..., k]
        assert ((nxt == first + k) | (nxt == -1)).all()
        assert (first[nxt >= 0] // w == nxt[nxt >= 0] // w).all()


@pytest.mark.parametrize("h,w,staged,tile_h,tile_w", [
    (96, 96, False, 16, 32), (96, 96, True, 32, 32), (97, 95, True, 32, 32),
    (7, 11, False, 8, 64), (7, 11, True, 8, 128),
    (1, 1001, False, 1, 512), (1, 1001, True, 1, 1024), (2, 5, True, 2, 512),
])
def test_tiling_rule(h, w, staged, tile_h, tile_w):
    tile = _tiles.tiling(h, w, staged)
    assert tile.threads == (_tiles.THREADS_STAGED if staged else _tiles.THREADS_DIRECT)
    assert (tile.tile_h, tile.tile_w) == (tile_h, tile_w)
    assert tile.tile_h * tile.tile_w == tile.threads * _tiles.PIXELS_PER_THREAD
    assert tile.threads <= _tiles.MAX_THREADS


@pytest.mark.parametrize("w,coords_ptr,out_ptr,path", [
    (96, 0x7000, 0x9000, "vector"),
    (95, 0x7000, 0x9000, "scalar"),  # width no multiple of 4
    (11, 0x7000, 0x9000, "scalar"),
    (96, 0x7008, 0x9000, "scalar"),  # coords 8 bytes past a 16-byte boundary
    (96, 0x7000, 0x9004, "scalar"),  # out not 16-byte aligned
])
def test_io_path_rule(w, coords_ptr, out_ptr, path):
    assert _tiles.io_path(w, coords_ptr, out_ptr) == path


def test_io_path_refuses_coords_off_an_8_byte_boundary():
    with pytest.raises(ValueError, match="8-byte"):
        _tiles.io_path(96, 0x7004, 0x9000)


@pytest.mark.parametrize("w,itemsize,ptr,ok", [
    (640, 1, 0x10000, True),
    (160, 1, 0x10000, True),
    (53, 1, 0x10000, False),  # row pitch 53 bytes
    (53, 4, 0x10000, False),  # row pitch 212 bytes
    (164, 4, 0x10000, True),  # 656 bytes a row
    (164, 1, 0x10000, False),
    (650, 1, 0x10000, False),
    (640, 1, 0x10008, False),  # base off a 16-byte boundary
    (640, 4, 0x10004, False),
    (48, 1, 0x10000, True),  # narrower than the window: still whole chunks
])
def test_window_eligible_rule(w, itemsize, ptr, ok):
    assert _tiles.window_eligible(w, itemsize, ptr) is ok


@pytest.mark.parametrize("width,itemsize,crop,coords_ptr,staged,path", [
    (640, 1, (96, 96), 0x7000, False, "vector"),  # the pool warp
    (640, 1, (96, 96), 0x7000, True, "vector+cp_async"),  # the windowed warp
    (640, 4, (96, 96), 0x7000, True, "vector+cp_async"),
    (640, 1, (97, 95), 0x7000, True, "scalar+cp_async"),
    (53, 1, (7, 11), 0x7000, True, "scalar"),  # cannot be staged
    (53, 1, (7, 11), 0x7000, False, "scalar"),
    (650, 1, (96, 96), 0x7000, True, "vector"),
    (640, 1, (96, 96), 0x7008, True, "scalar+cp_async"),
    (640, 1, (96, 96), 0x7008, False, "scalar"),
])
def test_plan_names_the_path(width, itemsize, crop, coords_ptr, staged, path):
    plan = _tiles.plan(width, itemsize, 0x10000, crop, coords_ptr, 0x9000, staged)
    assert plan.path == path
    assert plan.vector == path.startswith("vector")
    assert plan.staged == path.endswith(_tiles.STAGED_SUFFIX)
    assert plan.tiling == _tiles.tiling(*crop, staged=plan.staged)
    with pytest.raises(ValueError, match="8-byte"):
        _tiles.plan(width, itemsize, 0x10000, crop, coords_ptr + 4, 0x9000, staged)


@pytest.mark.parametrize("h,w,small", [
    (480, 640, False), (120, 160, True), (37, 53, True), (200, 650, False),
    (_tiles.WIN_ROWS, _tiles.WIN_COLS, False), (_tiles.WIN_ROWS - 1, 640, True),
    (480, _tiles.WIN_COLS - 1, True),
])
def test_small_image_rule(h, w, small):
    assert (warp_image_module.WIN_ROWS, warp_image_module.WIN_COLS) == (_tiles.WIN_ROWS, _tiles.WIN_COLS)
    assert _tiles.small_image(h, w) is small


def test_constants_are_checked_against_the_library():
    built = list(_tiles.CONSTANTS) + [-1]
    _tiles.check_constants(lambda i: built[i], "csrc/x.cu")
    built[2] += 8  # a library built with another window
    with pytest.raises(RuntimeError, match="constants"):
        _tiles.check_constants(lambda i: built[i], "csrc/x.cu")
    # the window holds whole 16-byte chunks of either element type
    assert _tiles.WIN_COLS % 16 == 0


def test_build_key_follows_the_header(tmp_path, monkeypatch):
    """An edited header must not meet a stale library: the key hashes every
    file under csrc/, the shared header included."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int k = 1;\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    key = _build._sources_key()
    assert key == _build._sources_key()
    (tmp_path / "common.cuh").write_text("constexpr int k = 2;\n")
    assert _build._sources_key() != key


def test_crop_shape_of_a_coordinate_list():
    img, imgs = torch.zeros((20, 30)), torch.zeros((2, 20, 30))
    shape = warp_image_module._crop_shape
    assert shape(imgs, torch.zeros((2, 96, 48, 2))) == (96, 48)
    assert shape(imgs, torch.zeros((2, 3, 96, 48, 2))) == (288, 48)
    assert shape(imgs, torch.zeros((2, 1001, 2))) == (1, 1001)
    assert shape(img, torch.zeros((1001, 2))) == (1, 1001)
    assert shape(img, torch.zeros((2,))) == (1, 1)
    assert shape(img, torch.zeros((4, 5, 2))) == (4, 5)


@pytest.mark.parametrize("wrapper", [warp_pool, warp_image_full, warp_image_windowed])
def test_wrappers_refuse_what_the_kernels_do_not_take(wrapper):
    """CPU tensors take the plain version and count no launch; the launch
    functions, where the counts are kept, refuse them."""
    pool = torch.zeros((2, 20, 30), dtype=torch.uint8)
    coords = torch.zeros((2, 4, 5, 2))
    extra = (torch.tensor([0, 1], dtype=torch.int32),) if wrapper is warp_pool else ()
    before = wrapper.launches
    assert wrapper(pool, coords, *extra).shape == (2, 4, 5)
    assert wrapper.launches == before  # CPU tensors take the plain version
    launch = {warp_pool: lambda: warp_pool_module._launch(pool, coords, *extra),
              warp_image_full: lambda: warp_image_module._launch_full(pool, coords, 2, 20),
              warp_image_windowed: lambda: warp_image_module._launch_windowed(pool, coords, 2)}[wrapper]
    with pytest.raises(ValueError, match="unsupported device"):
        launch()
    assert wrapper.launches == before
    with pytest.raises(TypeError):
        wrapper(pool.to(torch.float64), coords, *extra)
    with pytest.raises(TypeError):
        wrapper(pool, coords.to(torch.float16), *extra)
    with pytest.raises(ValueError):
        wrapper(pool, coords.transpose(1, 2), *extra)  # not contiguous
    with pytest.raises(ValueError):
        wrapper(pool[:, ::2], coords, *extra)
    with pytest.raises(ValueError):
        wrapper(pool.to("meta"), coords, *extra)  # devices differ
    if wrapper is warp_pool:
        for bad in ([0, 2], [-1, 0]):
            with pytest.raises(IndexError):
                wrapper(pool, coords, torch.tensor(bad, dtype=torch.int32))
