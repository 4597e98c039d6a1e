#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``umetrack_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:

1. the device (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of ``umetrack_torch/csrc/warp_pool.cu`` and ``warp_image.cu``
   with their shared header (both ``nvcc`` runs started together,
   ``-Xptxas -v`` condensed to a line per kernel) and its time;
3. the image-pool warp kernel against its plain PyTorch version on the card,
   at the tracker's bench shape (64 sequences x 16 frames: 4096 pool images
   of 480 x 640, 4096 warps of 96 x 96, coordinates from the port's own
   crop geometry) and on edge cases (crops that take the scalar path, pools
   that cannot be staged, misaligned coordinate views), the path taken
   checked each time; the time of a call of the wrapper (median of single
   calls) and of the kernel alone (launches back to back), the byte bound
   and the streaming floor (``stream_ms``);
4. ``track_sequences_batched`` at the full width of ``ModelConfig()`` (f32),
   S=64, T=16, seeded random weights: one kernel launch per call, finite
   outputs, wall time per call and frames/s; then one call under
   torch.profiler (device time by kernel, the device's busy share);
5. the two single-image warp kernels (``warp_image_full``,
   ``warp_image_windowed``) against their plain version: the torch_data
   shape (512 images of 480 x 640, uint8 and f32, coordinate fields from
   the port's preprocess geometry), 120 x 160 images (dispatch to the full
   kernel), a flat list, the edge cases, scattered / empty / mixed blocks,
   images whose row pitch cannot be staged, misaligned coordinate views;
   windowed == full bit for bit everywhere and == the pool kernel per slot;
   times as in phase 3, byte bounds, and the tiled kernel's staged form
   against its unstaged form on the same data;
6. the torch_data inference app ``run`` over a synthetic on-disk tree (32
   sequences x 16 frames x 2 views of 480 x 640) at full width: one
   windowed-kernel launch per batch, finite error, sequences/s and frames/s,
   where a batch's time goes, one batch under torch.profiler; then a
   120 x 160 tree (one full-kernel launch per batch);
7. card against CPU, TF32 off: the tracker at S=2, T=4 (1e-3 rad, 0.1 mm),
   the torch_data ``_run_batch`` on 2 sequences of T=4 (0.1 mm, crops within
   2e-3), and on the card the tracker with ``sampler="kernel_win"`` against
   the pool sampler;
8. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It needs CUDA and the repository around it; without either it exits
non-zero.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

S_BENCH, T_BENCH = 64, 16
S_SMALL, T_SMALL = 2, 4
TRACK_CALLS = 3
TD_SEQS, TD_BATCH, TD_T, TD_V = 32, 16, 16, 2  # the torch_data slice
TD_H, TD_W = 480, 640
KERNEL_ATOL = 2e-2  # on the 0-255 scale, the JAX tests' bound
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published
OPS_PER_SAMPLE = 17  # f32 operations of one bilinear sample, roughly
NO_LIBRARY = ("no single PyTorch call computes this function (grid_sample zero-pads "
              "per tap, not per floor cell, and takes float images and normalised grids)")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"FAILED: {msg}")


def log(*args):
    print(*args, flush=True)


def median_ms(fn, reps, warmup=2):
    """Median over ``reps`` launches, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def wall_ms(fn):
    """Host-clock milliseconds of ``fn()``, device work included."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    """Both sources at once (one nvcc each), then both libraries loaded."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor

    from umetrack_torch.ops import _build

    wp_mod = importlib.import_module("umetrack_torch.ops.warp_pool")
    wi_mod = importlib.import_module("umetrack_torch.ops.warp_image")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        paths = list(pool.map(lambda name: _build.build(name, verbose=True),
                              (wp_mod.NAME, wi_mod.NAME)))
    wp_mod._library()
    wi_mod._library()
    log(f"[build] {', '.join(os.path.relpath(p, HERE) for p in paths)} "
        f"in {time.perf_counter() - t0:.2f} s")
    return wp_mod, wi_mod


def touched_source_bytes(pool, coords, src_idx):
    """Distinct pool bytes the valid samples' four taps read."""
    import torch
    from umetrack_torch.ops.resample import _sample_prep

    m, h, w = pool.shape
    valid, x0, y0, _, _ = _sample_prep(h, w, coords)
    base = (src_idx.to(torch.int64).reshape(-1, 1, 1) * (h * w) + y0 * w + x0)[valid]
    mask = torch.zeros(m * h * w, dtype=torch.bool, device=pool.device)
    for off in (0, 1, w, w + 1):
        mask[base + off] = True
    return int(mask.sum()) * pool.element_size()


def byte_bound(pool, coords, src_idx):
    """(bound_ms, bound_by, text): coordinates read once, output written
    once, and the distinct source bytes touched, at the card's memory rate;
    against the sample arithmetic at the card's f32 rate."""
    taps = touched_source_bytes(pool, coords, src_idx)
    n_pix = coords.numel() // 2
    moved = coords.numel() * 4 + n_pix * 4 + taps
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_pix * OPS_PER_SAMPLE / F32_OPS_PER_S * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    text = (f"{bound_by}: coords {coords.numel() * 4 / 1e6:.1f} MB + out {n_pix * 4 / 1e6:.1f} MB "
            f"+ touched taps {taps / 1e6:.1f} MB at 3.35 TB/s")
    return bound_ms, bound_by, text


def edge_cases(device):
    """(pool, coords, src_idx) cases: duplicated sources, out of bounds,
    -1, NaN, inf, W-1 and H-1 exactly, the last valid cell, and shapes that
    are no multiple of the block."""
    import torch

    g = torch.Generator().manual_seed(7)
    cases = []
    for dtype in (torch.uint8, torch.float32):
        pool = (torch.rand((3, 37, 53), generator=g) * 255).to(dtype)
        coords = torch.rand((5, 7, 11, 2), generator=g) * torch.tensor([60.0, 44.0]) - 3.0
        special = torch.tensor([
            [-1.0, -1.0], [float("nan"), 5.0], [5.0, float("nan")], [52.0, 10.0],
            [10.0, 36.0], [51.999, 35.999], [51.5, 35.5], [0.0, 0.0],
            [float("inf"), 3.0], [-0.001, 3.0], [1e9, -1e9],
        ])
        coords[0, 0, : len(special)] = special
        src = torch.tensor([2, 0, 2, 1, 2], dtype=torch.int32)
        cases.append((pool.to(device), coords.to(device), src.to(device)))
    pool = (torch.rand((2, 480, 640), generator=g) * 255).to(torch.uint8)
    coords = torch.rand((3, 97, 95, 2), generator=g) * torch.tensor([660.0, 500.0]) - 10.0
    cases.append((pool.to(device), coords.to(device), torch.tensor([1, 1, 0], dtype=torch.int32, device=device)))
    return cases


BURST = 40  # calls made back to back by ``burst_ms``


def burst_ms(fn, n):
    """Mean over ``n`` calls made back to back between one pair of CUDA
    events: free of the per-call event and host jitter that a median of
    single calls carries."""
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, reps=20):
    """Mean device time of the port's own kernels (names holding ``warp_``)
    over ``reps`` calls of ``fn`` under torch.profiler: the kernel alone,
    whatever the host takes to make a launch (at the smaller shapes a call
    from Python takes as long as the kernel runs, so launches made back to
    back would time the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "warp_" in e.key:
            dev = getattr(e, "self_device_time_total", None)
            total_us += e.self_cuda_time_total if dev is None else dev
            count += e.count
    # the profiler may drop a launch at either end of its window
    check(reps - 2 <= count <= reps and total_us > 0,
          f"the profiler saw {count} kernel launches in {reps} calls")
    return total_us / count / 1e3


def stream_floor_ms(coords):
    """(sum_ms, cast_ms): two single PyTorch passes that read the coordinates
    and write an output-sized 4-byte tensor, touching no image: what streaming
    the kernel's two big operands costs on this card.  ``coords.sum(-1)`` is
    a reduction kernel; the cast of each (x, y) pair, viewed as one 8-byte
    integer, to 4 bytes is a plain elementwise pass over the same bytes."""
    import torch

    pairs = coords.view(torch.int64)
    return (burst_ms(lambda: coords.sum(-1), BURST),
            burst_ms(lambda: pairs.to(torch.int32), BURST))


def misaligned_view(coords, offset_floats):
    """A contiguous copy of ``coords`` that starts ``offset_floats`` floats
    past an aligned allocation."""
    import torch

    buf = torch.empty(coords.numel() + offset_floats, dtype=coords.dtype, device=coords.device)
    view = buf[offset_floats:].view(coords.shape)
    view.copy_(coords)
    return view


def phase_kernel(wp_mod, rigs, seqs, hands, card):
    import torch
    from umetrack_torch.ops.resample import bilinear_sample_pool_plain
    from umetrack_torch.tracker import TrackerConfig
    from umetrack_torch.tracker.tracker import pool_warp_operands

    warp_pool = wp_mod.warp_pool

    def run(p, c, s, want_path, label):
        """The kernel against its plain version; the path taken, checked."""
        before = warp_pool.paths[want_path]
        ok = warp_pool(p, c, s)
        pl = bilinear_sample_pool_plain(p, c, s)
        torch.cuda.synchronize()
        check(warp_pool.paths[want_path] == before + 1,
              f"{label}: expected path {want_path}, counts {dict(warp_pool.paths)}")
        check(bool(torch.isfinite(ok).all()), f"{label}: non-finite output")
        e = float((ok - pl).abs().max())
        check(e <= KERNEL_ATOL, f"{label}: kernel vs plain {e}")
        log(f"[kernel] {label}: pool {tuple(p.shape)} {str(p.dtype)[6:]}, crops {tuple(c.shape[:3])}, "
            f"path {want_path}, max_abs_err {e:.3e}, bit for bit {bool(torch.equal(ok, pl))}")
        return e, ok

    pool, coords, src = pool_warp_operands(TrackerConfig(), rigs, seqs, hands)
    err, out_k = run(pool, coords, src, "vector", "bench shape")
    log(f"[kernel] bench shape nonzero samples {float((out_k != 0).float().mean()):.3f}")

    g = torch.Generator().manual_seed(23)
    edge_err = 0.0
    for i, (p, c, s) in enumerate(edge_cases("cuda")):
        # 7 x 11 and 97 x 95 crops: the scalar path
        e, ok = run(p, c, s, "scalar", f"edge case {i}")
        if i < 2:
            invalid = ok[0, 0, [0, 1, 2, 3, 4, 8, 9, 10]]
            check(bool((invalid == 0).all()), f"edge case {i}: invalid samples not 0")
        edge_err = max(edge_err, e)
    # a pool whose row pitch is no multiple of 16 bytes: vector I/O all the same
    odd = (torch.rand((3, 200, 650), generator=g) * 255).to(torch.uint8).cuda()
    odd_coords = (torch.rand((4, 96, 96, 2), generator=g) * torch.tensor([670.0, 220.0]) - 10.0).cuda()
    odd_src = torch.tensor([2, 0, 1, 2], dtype=torch.int32, device="cuda")
    edge_err = max(edge_err, run(odd, odd_coords, odd_src, "vector", "650-wide pool")[0])
    # an f32 pool, crops of 64 x 32
    f32_pool = (torch.rand((2, 100, 164), generator=g) * 255).cuda()
    f32_coords = (torch.rand((3, 64, 32, 2), generator=g) * torch.tensor([170.0, 104.0]) - 3.0).cuda()
    f32_src = torch.tensor([1, 0, 1], dtype=torch.int32, device="cuda")
    edge_err = max(edge_err, run(f32_pool, f32_coords, f32_src, "vector", "164-wide f32 pool")[0])
    # a coordinate view 8 bytes past a 16-byte boundary: the scalar path; 4 bytes past: refused
    shifted = misaligned_view(odd_coords, 2)
    check(shifted.data_ptr() % 16 == 8 and shifted.is_contiguous(), "misaligned view")
    edge_err = max(edge_err, run(odd, shifted, odd_src, "scalar", "coords 8 bytes off")[0])
    refused = False
    try:
        warp_pool(odd, misaligned_view(odd_coords, 1), odd_src)
    except ValueError:
        refused = True
    check(refused, "coords 4 bytes off a boundary were not refused")
    log(f"[kernel] coords 4 bytes off an 8-byte boundary: refused; edge cases max_abs_err {edge_err:.3e}")
    del odd, odd_coords, shifted, f32_pool, f32_coords

    # `ms`: one call of the wrapper, the median of single calls (its checks
    # wait for the card once), as every earlier run of this script timed it;
    # `kernel_ms`: the kernel alone, its device time in the profiler
    ms = median_ms(lambda: warp_pool(pool, coords, src), reps=20)
    kernel_ms = device_ms(lambda: wp_mod._launch(pool, coords, src))
    check_ms = burst_ms(lambda: wp_mod._check(pool, coords, src), BURST)
    plain_ms = median_ms(lambda: bilinear_sample_pool_plain(pool, coords, src), reps=5, warmup=1)
    stream_ms, cast_ms = stream_floor_ms(coords)
    bound_ms, bound_by, text = byte_bound(pool, coords, src)
    log(f"[kernel] warp_pool {ms:.4f} ms a call of the wrapper (median of 20 single calls; its "
        f"checks alone {check_ms:.4f} ms), kernel alone {kernel_ms:.4f} ms (device time, mean of 20 "
        f"launches), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({text}), roofline share "
        f"{bound_ms / ms:.3f} of a call, {bound_ms / kernel_ms:.3f} of the kernel alone [{card}]")
    log(f"[kernel] stream_ms {stream_ms:.4f} (the streaming floor: coords.sum(-1), "
        f"{coords.numel() * 4 / 1e6:.1f} MB in, {coords.numel() * 2 / 1e6:.1f} MB out, no taps; back to back); "
        f"the same bytes as an elementwise cast {cast_ms:.4f} ms [{card}]")
    log(f"[kernel] library_ms null: {NO_LIBRARY}; it would also need a per-warp image")
    kern = dict(max_abs_err=max(err, edge_err), ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)
    return kern, (pool, coords, src)


# ---- the two single-image kernels ------------------------------------------


def block_stats(wi_mod, images, coords):
    """How the windowed kernel's blocks fall: (blocks, blocks with no valid
    sample, blocks whose box fits the window), reckoned from the coordinates
    the way the kernel does: its tile for this field, the box of each tile's
    valid floor cells, the cp.async window with its 16-byte column start."""
    import torch
    from umetrack_torch.ops.resample import _sample_prep

    h, w = images.shape[-2:]
    n = images.shape[0] if images.dim() == 3 else 1
    ch, cw = wi_mod._crop_shape(images, coords)
    plan = windowed_plan(wi_mod, images, coords)
    tile = plan.tiling
    valid, x0, y0, _, _ = _sample_prep(h, w, coords.reshape(n, ch, cw, 2))
    pad = (0, -cw % tile.tile_w, 0, -ch % tile.tile_h)
    big = torch.iinfo(torch.int64).max

    def blocks(a, fill):  # [n, ch, cw] -> [n, tiles, pixels of a tile]
        a = torch.nn.functional.pad(a, pad, value=fill)
        a = a.reshape(n, a.shape[1] // tile.tile_h, tile.tile_h, a.shape[2] // tile.tile_w, tile.tile_w)
        return a.permute(0, 1, 3, 2, 4).reshape(n, -1, tile.tile_h * tile.tile_w)

    v = blocks(valid, False)
    lo = lambda a: torch.where(v, blocks(a, 0), big).amin(dim=-1)
    hi = lambda a: torch.where(v, blocks(a, 0), -big).amax(dim=-1)
    any_valid = v.any(dim=-1)
    chunk = 16 // images.element_size()
    cols = (hi(x0) + 1 - lo(x0) // chunk * chunk) // chunk * chunk + chunk
    fits = any_valid & (cols <= wi_mod.WIN_COLS) & (hi(y0) - lo(y0) + 2 <= wi_mod.WIN_ROWS)
    fits &= plan.staged  # images that cannot be staged: every block reads in place
    return v.shape[0] * v.shape[1], int((~any_valid).sum()), int(fits.sum())


def windowed_plan(wi_mod, images, coords):
    """The launch the windowed wrapper's rules give these operands (the
    output of a launch is a fresh allocation, aligned)."""
    from umetrack_torch.ops import _tiles

    return _tiles.plan(
        images.shape[-1], images.element_size(), images.data_ptr(),
        wi_mod._crop_shape(images, coords), coords.data_ptr(), 0, staged=True)


def windowed_path(wi_mod, images, coords):
    return windowed_plan(wi_mod, images, coords).path


def compare_image_kernels(wi_mod, images, coords, label):
    """Both kernels against the plain version within KERNEL_ATOL, windowed
    == full bit for bit, launch counters and the windowed kernel's path as
    the dispatch rules say.  Returns the max abs error."""
    import torch
    from umetrack_torch.ops import _tiles
    from umetrack_torch.ops.resample import bilinear_sample_plain

    full_fn, win_fn = wi_mod.warp_image_full, wi_mod.warp_image_windowed
    h, w = images.shape[-2:]
    small = _tiles.small_image(h, w)
    check(small == (h < wi_mod.WIN_ROWS or w < wi_mod.WIN_COLS), f"{label}: small-image rule")
    want = "full kernel" if small else windowed_path(wi_mod, images, coords)
    before = (full_fn.launches, win_fn.launches, win_fn.paths[want])
    full = full_fn(images, coords)
    win = win_fn(images, coords)
    plain = bilinear_sample_plain(images, coords)
    torch.cuda.synchronize()
    got = (full_fn.launches - before[0], win_fn.launches - before[1])
    check(got == ((2, 0) if small else (1, 1)),
          f"{label}: launches (full, windowed) {got} for a {h} x {w} image")
    check(small or win_fn.paths[want] == before[2] + 1,
          f"{label}: expected path {want}, counts {dict(win_fn.paths)}")
    check(full.shape == coords.shape[:-1], f"{label}: output shape {tuple(full.shape)}")
    check(bool(torch.isfinite(full).all()), f"{label}: non-finite output")
    err = float((full - plain).abs().max())
    check(err <= KERNEL_ATOL, f"{label}: full kernel vs plain {err}")
    check(bool(torch.equal(win, full)), f"{label}: windowed != full bit for bit")
    n_blocks, n_empty, n_fit = block_stats(wi_mod, images, coords)
    log(f"[image-kernels] {label}: images {tuple(images.shape)} {str(images.dtype)[6:]}, "
        f"coords {tuple(coords.shape)}, max_abs_err {err:.3e}, windowed == full, windowed path {want}, "
        f"blocks {n_blocks} (empty {n_empty}, fit {n_fit}, direct {n_blocks - n_empty - n_fit}), "
        f"nonzero {float((plain != 0).float().mean()):.3f}, launches full+{got[0]} windowed+{got[1]}")
    return err, (n_blocks, n_empty, n_fit)


def time_image_kernels(wi_mod, images, coords, label, card, plain_reps=5):
    """Both kernels' times at one shape (`ms`: one call of the wrapper, the
    median of single calls, as every earlier run of this script timed it;
    `kernel_ms`: the kernel alone, its device time in the profiler), the
    plain version's time and the byte bound."""
    import torch
    from umetrack_torch.ops import _tiles
    from umetrack_torch.ops.resample import bilinear_sample_plain

    n = images.shape[0]
    bound_ms, bound_by, text = byte_bound(
        images, coords, torch.arange(n, dtype=torch.int32, device=images.device))
    plain_ms = median_ms(lambda: bilinear_sample_plain(images, coords), reps=plain_reps, warmup=1)
    pixels = coords.numel() // 2 // n
    full_alone = lambda: wi_mod._launch_full(images, coords, n, pixels)
    small = _tiles.small_image(*images.shape[-2:])  # the windowed wrapper runs the full kernel
    alone = {
        "warp_image_full": full_alone,
        "warp_image_windowed": full_alone if small else lambda: wi_mod._launch_windowed(images, coords, n),
    }
    out = {}
    for name, launch in alone.items():
        fn = getattr(wi_mod, name)
        ms = median_ms(lambda: fn(images, coords), reps=20)
        kernel_ms = device_ms(launch)
        out[name] = dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[image-kernels] {label}: {name} {ms:.4f} ms a call of the wrapper (median of 20 single "
            f"calls), kernel alone {kernel_ms:.4f} ms (device time, mean of 20 launches), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({text}), roofline share "
            f"{bound_ms / ms:.3f} of a call, {bound_ms / kernel_ms:.3f} of the kernel alone [{card}]")
    return out


def time_forms(wi_mod, images, coords, label, card, rounds=3):
    """The tiled kernel's two forms on the same data, through the wrapper's
    own rules: the images as given (staged, 32 x 32 tile) and a copy that
    starts 8 bytes off a 16-byte boundary, which cannot be staged (every tap
    in place, 16 x 32 tile); the full kernel beside them.  Equal bit for
    bit; device time in interleaved rounds of 20 launches each."""
    import torch

    n = images.shape[0]
    shifted = misaligned_view(images, 8 // images.element_size())
    paths = windowed_path(wi_mod, images, coords), windowed_path(wi_mod, shifted, coords)
    check(paths == ("vector+cp_async", "vector"), f"{label}: paths of the two forms {paths}")
    reference = wi_mod._launch_windowed(images, coords, n)
    check(bool(torch.equal(wi_mod._launch_windowed(shifted, coords, n), reference)),
          f"{label}: unstaged form != staged form")
    del reference
    pixels = coords.numel() // 2 // n
    runs = {
        "staged (vector+cp_async, tile 32 x 32)": lambda: wi_mod._launch_windowed(images, coords, n),
        "taps in place (vector, tile 16 x 32)": lambda: wi_mod._launch_windowed(shifted, coords, n),
        "warp_image_full": lambda: wi_mod._launch_full(images, coords, n, pixels),
    }
    times = {name: [] for name in runs}
    for _ in range(rounds):
        for name, fn in runs.items():
            times[name].append(device_ms(fn))
    for name, ms in times.items():
        log(f"[forms] {label}: {name}: min {min(ms):.4f} ms, rounds "
            f"{' '.join(f'{m:.4f}' for m in ms)} [{card}]")


def torchdata_batch(n_seqs, t, h, w, seed0=0):
    """Parsed host sequences of the synthetic torch_data kind."""
    from umetrack_torch.data.transform import parse_raw_buffers
    from umetrack_torch.utils.synthetic import make_torchdata_sample

    return [
        parse_raw_buffers(*make_torchdata_sample(
            rng_seed=seed0 + i, t=t, v=TD_V, h=h, w=w, hand_idx=i % 2))
        for i in range(n_seqs)
    ]


def torchdata_warp_operands(raws, device="cuda"):
    """(images [B*T*V, H, W] uint8, coords [B*T*V, 96, 96, 2]) as
    ``preprocess_sequence`` hands them to the sampler."""
    from umetrack_torch.data import bundles
    from umetrack_torch.data.transform import crop_homographies
    from umetrack_torch.ops.resample import homography_coords

    raw = bundles.to_device(bundles.collate(raws), device)
    _, _, xf = crop_homographies(raw)
    images = raw.images.reshape(-1, *raw.images.shape[-2:])
    return images, homography_coords(xf.reshape(-1, 4, 4), (96, 96))


def phase_image_kernels(wi_mod, wp_mod, pool_operands, card):
    import torch

    g = torch.Generator().manual_seed(11)
    errs = []
    run = lambda *a: errs.append(compare_image_kernels(wi_mod, *a)[0])

    # (a) the torch_data shape, coordinates from the preprocess geometry
    images, coords = torchdata_warp_operands(torchdata_batch(TD_BATCH, TD_T, TD_H, TD_W))
    check(images.shape == (TD_BATCH * TD_T * TD_V, TD_H, TD_W) and images.dtype == torch.uint8,
          f"torch_data images {tuple(images.shape)} {images.dtype}")
    run(images, coords, "torch_data uint8")
    images_f = images.to(torch.float32) + 0.25  # fractional content: f32 is sampled exactly
    run(images_f, coords, "torch_data f32")
    times = time_image_kernels(wi_mod, images, coords, "torch_data uint8", card)
    time_image_kernels(wi_mod, images_f, coords, "torch_data f32", card)

    time_forms(wi_mod, images, coords, "torch_data uint8", card)
    del images_f

    # (c) 120 x 160 frames: smaller than the window, the full kernel both
    # ways; the shape at which the main path runs the full kernel.  The
    # tiled kernel forced onto them, beside the full kernel the rule picks.
    small, small_coords = torchdata_warp_operands(torchdata_batch(TD_BATCH, TD_T, 120, 160, seed0=40))
    run(small, small_coords, "120 x 160 uint8")
    run(small.to(torch.float32), small_coords, "120 x 160 f32")
    times["warp_image_full"] = time_image_kernels(
        wi_mod, small, small_coords, "120 x 160 uint8", card)["warp_image_full"]
    forced = wi_mod._launch_windowed(small, small_coords, small.shape[0])
    check(bool(torch.equal(forced, wi_mod.warp_image_full(small, small_coords))),
          "120 x 160: the tiled kernel != the full kernel")
    forced_ms = device_ms(lambda: wi_mod._launch_windowed(small, small_coords, small.shape[0]))
    log(f"[image-kernels] 120 x 160 uint8: the tiled kernel ({windowed_path(wi_mod, small, small_coords)}) forced past the "
        f"small-image rule {forced_ms:.4f} ms, the full kernel "
        f"{times['warp_image_full']['kernel_ms']:.4f} ms [{card}]")
    del forced, small, small_coords

    # (d) one image, a flat list that fills no block
    flat = (torch.rand((1001, 2), generator=g) * torch.tensor([700.0, 540.0]) - 30.0).cuda()
    run(images[3], flat, "flat list [1001, 2]")

    # (e) the pool kernel's edge cases, per image
    for i, (p, c, s) in enumerate(edge_cases("cuda")):
        per_slot = p.index_select(0, s.to(torch.int64))
        run(per_slot, c, f"edge case {i}")
        if i < 2:
            out = wi_mod.warp_image_windowed(per_slot, c)
            check(bool((out[0, 0, [0, 1, 2, 3, 4, 8, 9, 10]] == 0).all()),
                  f"edge case {i}: invalid samples not 0")

    # (g) images whose row pitch is no multiple of 16 bytes (vector I/O, taps
    # in place), f32 images that can be staged, and coordinate views 8 bytes
    # past a 16-byte boundary (the scalar path) or 4 bytes past (refused)
    odd = (torch.rand((4, 200, 650), generator=g) * 255).to(torch.uint8).cuda()
    odd_coords = (torch.rand((4, 96, 96, 2), generator=g) * torch.tensor([670.0, 220.0]) - 10.0).cuda()
    check(windowed_path(wi_mod, odd, odd_coords) == "vector", "650-wide images: path rule")
    run(odd, odd_coords, "650-wide uint8")
    wide = (torch.rand((3, 150, 164), generator=g) * 255).cuda()
    wide_coords = (torch.rand((3, 64, 32, 2), generator=g) * torch.tensor([60.0, 50.0])
                   + torch.tensor([40.0, 30.0])).cuda()
    check(windowed_path(wi_mod, wide, wide_coords) == "vector+cp_async", "164-wide f32: path rule")
    run(wide, wide_coords, "164-wide f32")
    shifted = misaligned_view(coords[:4], 2)
    check(windowed_path(wi_mod, images[:4], shifted).startswith("scalar"), "shifted coords: path rule")
    run(images[:4], shifted, "coords 8 bytes off")
    for fn in (wi_mod.warp_image_full, wi_mod.warp_image_windowed):
        refused = False
        try:
            fn(images[:4], misaligned_view(coords[:4], 1))
        except ValueError:
            refused = True
        check(refused, f"{fn.__name__}: coords 4 bytes off a boundary were not refused")
    log("[image-kernels] coords 4 bytes off an 8-byte boundary: refused by both wrappers")
    del odd, odd_coords, wide, wide_coords, shifted

    # (f) blocks that cannot fit, blocks with no valid sample, and a mix
    sub = images[:8]
    scattered = (torch.rand((8, 96, 96, 2), generator=g) * torch.tensor([660.0, 500.0]) - 10.0).cuda()
    _, (nb, ne, nf) = compare_image_kernels(wi_mod, sub, scattered, "scattered")
    check(nf == 0 and ne == 0, f"scattered: {nf} blocks fit, {ne} empty")
    empty = coords[:8].clone()
    empty[0] = -1.0
    empty[1] = float("nan")
    empty[2, :48] = 1e9
    empty[3, 10:40] = float("-inf")
    _, (nb, ne, nf) = compare_image_kernels(wi_mod, sub, empty, "empty blocks")
    check(ne > 0 and nf > 0, f"empty blocks: {ne} empty, {nf} fit")
    mix = coords[:8].clone()
    mix[0, :32] = scattered[0, :32]  # these blocks take the direct path
    mix[1, 40:] = -1.0  # these stage nothing
    holes = torch.rand((8, 96, 96), generator=g).cuda() < 0.1
    mix[..., 0] = torch.where(holes, torch.full_like(mix[..., 0], float("nan")), mix[..., 0])
    mix[2, ::7, ::5] = -1.0
    _, (nb, ne, nf) = compare_image_kernels(wi_mod, sub, mix, "mixed blocks")
    check(ne > 0 and nf > 0 and nb - ne - nf > 0, f"mixed: {nb} blocks, {ne} empty, {nf} fit")
    del images, coords, sub

    # (b) the tracker's bench shape expressed per image: every slot samples
    # its own copy of its source view; also held against the pool kernel
    pool, pcoords, src = pool_operands
    per_slot = pool.index_select(0, src.to(torch.int64))
    run(per_slot, pcoords, "tracker bench per image")
    win_out = wi_mod.warp_image_windowed(per_slot, pcoords)
    check(bool(torch.equal(win_out, wp_mod.warp_pool(pool, pcoords, src))),
          "pool kernel != windowed kernel per slot bit for bit")
    check(bool(torch.equal(win_out, wi_mod.warp_image_full(per_slot, pcoords))),
          "pool kernel != full kernel per slot bit for bit")
    log("[image-kernels] tracker bench per image: pool kernel == windowed == full per slot, bit for bit")
    time_image_kernels(wi_mod, per_slot, pcoords, "tracker bench per image", card, plain_reps=3)
    del win_out
    time_forms(wi_mod, per_slot, pcoords, "tracker bench per image", card)
    log(f"[image-kernels] library_ms null: {NO_LIBRARY}")
    for v in times.values():
        v["max_abs_err"] = max(errs)
    return times


# ---- the tracker slice ------------------------------------------------------


def phase_slice(wp_mod, model, rigs, seqs, hands, card):
    import torch
    from umetrack_torch.tracker import HandTracker, TrackerConfig
    from umetrack_torch.tracker.tracker import pool_warp_operands

    tracker = HandTracker(model, TrackerConfig(), device="cuda")
    s, t = seqs.gt_confidences.shape[:2]
    wp_mod.warp_pool.launches = 0
    times = []
    for _ in range(1 + TRACK_CALLS):  # the first call warms cuDNN up
        before = wp_mod.warp_pool.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, state = tracker.track_sequences_batched(rigs, seqs, hands)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(wp_mod.warp_pool.launches == before + 1,
              f"warp_pool launches per call: {wp_mod.warp_pool.launches - before}")
    n_launches = wp_mod.warp_pool.launches
    check(res.joint_angles.shape == (t, s, 2, 22), f"angles shape {tuple(res.joint_angles.shape)}")
    check(res.wrist_xfs.shape == (t, s, 2, 4, 4), f"wrist shape {tuple(res.wrist_xfs.shape)}")
    check(bool(torch.isfinite(res.joint_angles).all() & torch.isfinite(res.wrist_xfs).all()),
          "non-finite tracker output")
    check(bool(torch.isfinite(state.temporal.mem_features).all()), "non-finite memory")
    n_valid = int(res.valid.sum())
    check(0 < n_valid, "no valid hands")
    med = sorted(times[1:])[len(times[1:]) // 2]

    geom, _ = wall_ms(lambda: pool_warp_operands(TrackerConfig(), rigs, seqs, hands))
    log(f"[slice] track_sequences_batched S={s} T={t} full ModelConfig() f32: "
        f"{med * 1e3:.1f} ms/call median of {TRACK_CALLS} (first call {times[0] * 1e3:.1f} ms), "
        f"{s * t / med:.1f} frames/s, crop geometry alone {geom:.1f} ms, "
        f"valid hands {n_valid}/{res.valid.numel()}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return n_launches


def phase_profile(fn, label, kernel_name, card, top=15):
    """One warmed-up call of ``fn`` under torch.profiler: device time by
    kernel, the share of the kernels named ``kernel_name``, and the device's
    busy share of the call's wall time (one stream, so kernels do not
    overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # device kernels only, not the ops launching them
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = e.self_cuda_time_total
        if dev > 0:
            rows.append((dev, e.count, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    check(total > 0, "the profiler saw no device time")
    warp = sum(r[0] for r in rows if kernel_name in r[2])
    check(warp > 0, f"{label}: no {kernel_name} in the profile")
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device {total / 1e3:.1f} ms, "
        f"busy share {total / wall_us:.3f}, {kernel_name} {warp / 1e3:.3f} ms "
        f"({warp / total:.4f} of device time) [{card}]")
    for dev, count, key in rows[:top]:
        log(f"[profile] {dev / 1e3:9.3f} ms {dev / total:6.3f} x{count:<5d} {key[:100]}")


# ---- the torch_data slice ---------------------------------------------------


def reset_launches(wp_mod, wi_mod):
    wp_mod.warp_pool.launches = 0
    wi_mod.warp_image_full.launches = 0
    wi_mod.warp_image_windowed.launches = 0


def launches(wp_mod, wi_mod):
    return (wp_mod.warp_pool.launches, wi_mod.warp_image_full.launches,
            wi_mod.warp_image_windowed.launches)


def batch_breakdown(model, root, card):
    """Where one batch's time goes, stage by stage on the host clock with a
    synchronise after each (the app itself overlaps read + parse with the
    device through its prefetch threads)."""
    import numpy as np
    import torch
    from umetrack_torch.apps import run_inference_torch_data as app
    from umetrack_torch.data import IdxBinFile, bundles, find_torchdata_folders
    from umetrack_torch.data.transform import (
        crop_homographies, parse_raw_buffers, preprocess_sequence)
    from umetrack_torch.ops.resample import bilinear_sample, homography_coords

    folder = find_torchdata_folders(root, ["mono", "labels"])[0]
    files = {f: IdxBinFile.open(os.path.join(folder, f + ".torch.idx")) for f in ("mono", "labels")}
    t0 = time.perf_counter()
    monos = [files["mono"][i] for i in range(TD_BATCH)]  # zero-copy views of the mmap
    t_mono = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    labels = [files["labels"][i] for i in range(TD_BATCH)]  # msgpack decode
    t_labels = (time.perf_counter() - t0) * 1e3
    label_kb = sum(len(files["labels"].frame_bytes(i)) for i in range(TD_BATCH)) / 1e3
    t0 = time.perf_counter()
    raws = [parse_raw_buffers(m, l) for m, l in zip(monos, labels)]
    t_parse = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = bundles.collate(raws)
    t_collate = (time.perf_counter() - t0) * 1e3
    t_upload, raw = wall_ms(lambda: bundles.to_device(batch, "cuda"))

    def geometry():
        _, _, xf = crop_homographies(raw)
        return homography_coords(xf.reshape(-1, 4, 4), (96, 96))

    geometry()
    t_geom, coords = wall_ms(geometry)
    images = raw.images.reshape(-1, TD_H, TD_W)
    t_warp = median_ms(lambda: bilinear_sample(images, coords), reps=10)
    preprocess_sequence(raw)
    t_pre, (model_input, target) = wall_ms(lambda: preprocess_sequence(raw))
    step_valid = torch.ones((TD_BATCH, TD_T), dtype=torch.bool, device="cuda")
    evaluate = lambda: app.eval_batch(
        model, model_input, target.gt_joint_angles, target.gt_wrist_xfs, 2, step_valid)
    evaluate()
    t_model, err = wall_ms(evaluate)
    check(bool(torch.isfinite(err).all()), "non-finite error in the breakdown batch")
    mb = sum(np.asarray(r.images).nbytes for r in raws) / 1e6
    log(f"[torch_data] one batch of {TD_BATCH} x {TD_T} x {TD_V} frames ({mb:.1f} MB uint8), by stage: "
        f"mono views {t_mono:.1f} ms, label decode (msgpack, {label_kb:.0f} KB) {t_labels:.1f} ms, "
        f"parse to numpy {t_parse:.1f} ms, collate {t_collate:.1f} ms, "
        f"upload {t_upload:.1f} ms, preprocess {t_pre:.1f} ms (geometry {t_geom:.1f} ms, "
        f"warp kernel {t_warp:.4f} ms), model loop + error {t_model:.1f} ms [{card}]")
    return raws


def phase_torchdata_slice(wp_mod, wi_mod, model, card):
    import math

    import torch
    from umetrack_torch.apps import run_inference_torch_data as app
    from umetrack_torch.data import Split
    from umetrack_torch.utils.synthetic import write_torchdata_corpus

    n_batches = TD_SEQS // TD_BATCH
    with tempfile.TemporaryDirectory(prefix="umetrack_torch_data_") as root:
        big, small = os.path.join(root, "big"), os.path.join(root, "small")
        t0 = time.perf_counter()
        write_torchdata_corpus(big, n_test=TD_SEQS, t=TD_T, v=TD_V, h=TD_H, w=TD_W)
        write_torchdata_corpus(small, n_test=TD_SEQS, t=TD_T, v=TD_V, h=120, w=160)
        log(f"[torch_data] wrote 2 x {TD_SEQS} sequences x {TD_T} frames x {TD_V} views "
            f"({TD_H} x {TD_W} and 120 x 160) in {time.perf_counter() - t0:.1f} s")

        # the main path: counts to 0, the app's run, counts read
        torch.cuda.reset_peak_memory_stats()
        reset_launches(wp_mod, wi_mod)
        first_ms, res = wall_ms(lambda: app.run([big], model, batch_size=TD_BATCH))
        counts = launches(wp_mod, wi_mod)
        check(set(res) == {Split.TEST} and math.isfinite(res[Split.TEST]),
              f"run over the {TD_H} x {TD_W} tree: {res}")
        check(counts == (0, 0, n_batches),
              f"{TD_H} x {TD_W} tree: launches (pool, full, windowed) {counts} in {n_batches} batches")
        walls = [wall_ms(lambda: app.run([big], model, batch_size=TD_BATCH))[0] for _ in range(3)]
        med = sorted(walls)[1]
        log(f"[torch_data] run() over {TD_SEQS} sequences, {TD_H} x {TD_W}, batch {TD_BATCH}, full "
            f"ModelConfig() f32: {med:.1f} ms/run median of 3 ({', '.join(f'{w:.1f}' for w in walls)}; "
            f"first run {first_ms:.1f} ms), {med / n_batches:.1f} ms/batch, "
            f"{TD_SEQS / med * 1e3:.1f} sequences/s, {TD_SEQS * TD_T / med * 1e3:.1f} frames/s, "
            f"one warp_image_windowed launch per batch, mean error {res[Split.TEST]:.1f} mm "
            f"(random weights: finite, no more), peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

        raws = batch_breakdown(model, big, card)
        phase_profile(lambda: app._run_batch(model, raws), "one torch_data batch (_run_batch)",
                      "warp_image_windowed_kernel", card, top=10)
        del raws

        reset_launches(wp_mod, wi_mod)
        small_ms, res_small = wall_ms(lambda: app.run([small], model, batch_size=TD_BATCH))
        counts_small = launches(wp_mod, wi_mod)
        check(math.isfinite(res_small[Split.TEST]), f"run over the 120 x 160 tree: {res_small}")
        check(counts_small == (0, n_batches, 0),
              f"120 x 160 tree: launches (pool, full, windowed) {counts_small}")
        log(f"[torch_data] run() over {TD_SEQS} sequences, 120 x 160: {small_ms:.1f} ms, "
            f"{TD_SEQS / small_ms * 1e3:.1f} sequences/s, one warp_image_full launch per batch [{card}]")
    return counts[2], counts_small[1]


# ---- card against CPU -------------------------------------------------------


class tf32_off:
    def __enter__(self):
        import torch

        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def track_diff(a, b):
    check(bool((a.valid == b.valid).all()), "valid masks differ")
    v = a.valid
    check(bool(v.any()), "no valid hands")
    da = float((a.joint_angles[v] - b.joint_angles[v]).abs().max())
    dw = float((a.wrist_xfs[v][..., :3, 3] - b.wrist_xfs[v][..., :3, 3]).abs().max())
    return da, dw


def phase_cpu_vs_card(model_cpu, model_cuda, wi_mod):
    from umetrack_torch.tracker import HandTracker, TrackerConfig
    from umetrack_torch.utils.synthetic import make_sequences

    rigs, seqs, hands = make_sequences(S_SMALL, T_SMALL, seed=100, device="cpu")
    on_card = (rigs.to("cuda"), seqs.to("cuda"), hands.to("cuda"))
    with tf32_off():
        res_cpu, _ = HandTracker(model_cpu, device="cpu").track_sequences_batched(rigs, seqs, hands)
        res_gpu, _ = HandTracker(model_cuda, device="cuda").track_sequences_batched(*on_card)
        before = wi_mod.warp_image_windowed.launches
        res_win, _ = HandTracker(
            model_cuda, TrackerConfig(sampler="kernel_win"), device="cuda"
        ).track_sequences_batched(*on_card)
        check(wi_mod.warp_image_windowed.launches == before + 1,
              "sampler='kernel_win': not one warp_image_windowed launch per call")
    da, dw = track_diff(res_cpu, res_gpu.to("cpu"))
    log(f"[cpu-vs-card] S={S_SMALL} T={T_SMALL} TF32 off: valid equal, "
        f"max angle diff {da:.3e} rad (<= 1e-3), max wrist diff {dw:.3e} mm (<= 0.1)")
    check(da <= 1e-3, f"angles differ by {da} rad")
    check(dw <= 0.1, f"wrist translations differ by {dw} mm")
    da, dw = track_diff(res_gpu, res_win)
    log(f"[cpu-vs-card] on the card, sampler='kernel_win' against the pool sampler: "
        f"max angle diff {da:.3e} rad (<= 1e-3), max wrist diff {dw:.3e} mm (<= 0.1)")
    check(da <= 1e-3 and dw <= 0.1, f"kernel_win vs pool: {da} rad, {dw} mm")


def phase_torchdata_cpu_vs_card(model_cpu, model_cuda):
    import numpy as np
    from umetrack_torch.apps.run_inference_torch_data import _run_batch
    from umetrack_torch.data import bundles
    from umetrack_torch.data.transform import preprocess_sequence

    raws = torchdata_batch(S_SMALL, T_SMALL, TD_H, TD_W, seed0=200)
    with tf32_off():
        err_cpu = _run_batch(model_cpu, raws)
        err_gpu = _run_batch(model_cuda, raws)
    batch = bundles.collate(raws)
    crops_cpu = preprocess_sequence(bundles.to_device(batch, "cpu"))[0].left_images
    crops_gpu = preprocess_sequence(bundles.to_device(batch, "cuda"))[0].left_images.cpu()
    d_err = float(np.abs(err_cpu - err_gpu).max())
    d_img = float((crops_cpu - crops_gpu).abs().max())
    log(f"[cpu-vs-card] torch_data _run_batch, {S_SMALL} sequences x T={T_SMALL}, TF32 off: "
        f"per-sample errors differ by {d_err:.3e} mm (<= 0.1), left_images by {d_img:.3e} (<= 2e-3)")
    check(np.isfinite(err_gpu).all(), "non-finite error on the card")
    check(d_err <= 0.1, f"per-sample errors differ by {d_err} mm")
    check(d_img <= 2e-3, f"left_images differ by {d_img}")


def kernel_entry(name, source, replaces, n_launches, numbers):
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": n_launches, "max_abs_err": numbers["max_abs_err"],
        "ms": numbers["ms"], "kernel_ms": numbers["kernel_ms"], "plain_ms": numbers["plain_ms"],
        "bound_ms": numbers["bound_ms"], "bound_by": numbers["bound_by"],
        "library_ms": None,
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_device()
    wp_mod, wi_mod = phase_build()

    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.utils.synthetic import make_sequences

    t0 = time.perf_counter()
    rigs, seqs, hands = make_sequences(S_BENCH, T_BENCH, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[inputs] {S_BENCH} sequences x {T_BENCH} frames, images {tuple(seqs.images.shape)} "
        f"{seqs.images.dtype}, made in {time.perf_counter() - t0:.1f} s")

    pool_kern, pool_operands = phase_kernel(wp_mod, rigs, seqs, hands, card)
    image_kern = phase_image_kernels(wi_mod, wp_mod, pool_operands, card)
    del pool_operands
    torch.cuda.empty_cache()

    model_cuda = make_model(ModelConfig(), seed=0, device="cuda")
    pool_launches = phase_slice(wp_mod, model_cuda, rigs, seqs, hands, card)
    tracker = HandTracker(model_cuda, device="cuda")
    phase_profile(lambda: tracker.track_sequences_batched(rigs, seqs, hands),
                  "one track_sequences_batched call", "warp_pool_kernel", card)
    del rigs, seqs, hands
    torch.cuda.empty_cache()

    win_launches, full_launches = phase_torchdata_slice(wp_mod, wi_mod, model_cuda, card)

    model_cpu = make_model(ModelConfig(), seed=0, device="cpu")
    phase_cpu_vs_card(model_cpu, model_cuda, wi_mod)
    phase_torchdata_cpu_vs_card(model_cpu, model_cuda)

    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    log(json.dumps({"kernels": [
        kernel_entry("warp_pool", "umetrack_torch/csrc/warp_pool.cu",
                     "umetrack_tpu/ops/pallas_resample.py:243", pool_launches, pool_kern),
        kernel_entry("warp_image_windowed", "umetrack_torch/csrc/warp_image.cu",
                     "umetrack_tpu/ops/pallas_resample.py:174", win_launches,
                     image_kern["warp_image_windowed"]),
        kernel_entry("warp_image_full", "umetrack_torch/csrc/warp_image.cu",
                     "umetrack_tpu/ops/pallas_resample.py:68", full_launches,
                     image_kern["warp_image_full"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
