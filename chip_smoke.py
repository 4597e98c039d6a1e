#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``umetrack_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:

1. the device (``nvidia-smi`` name and power limit, torch and CUDA versions);
2. the build of ``umetrack_torch/csrc/warp_pool.cu`` and its time;
3. the image-pool warp kernel against its plain PyTorch version on the card,
   at the tracker's bench shape (64 sequences x 16 frames: 4096 pool images
   of 480 x 640, 4096 warps of 96 x 96, coordinates from the port's own
   crop geometry) and on edge cases; median times, the byte bound;
4. ``track_sequences_batched`` at the full width of ``ModelConfig()`` (f32),
   S=64, T=16, seeded random weights: one kernel launch per call, finite
   outputs, wall time per call and frames/s; then one call under
   torch.profiler (device time by kernel, the device's busy share);
5. the same slice at S=2, T=4 on the CPU and on the card, TF32 off, held to
   1e-3 rad and 0.1 mm;
6. a ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

It needs CUDA and the repository around it; without either it exits
non-zero.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

S_BENCH, T_BENCH = 64, 16
S_SMALL, T_SMALL = 2, 4
TRACK_CALLS = 3
KERNEL_ATOL = 2e-2  # on the 0-255 scale, the JAX tests' bound
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores, published


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
    import importlib

    mod = importlib.import_module("umetrack_torch.ops.warp_pool")
    t0 = time.perf_counter()
    path = mod.build(verbose=True)
    mod._library()
    log(f"[build] {os.path.relpath(path, HERE)} in {time.perf_counter() - t0:.2f} s")
    return mod


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


def phase_kernel(wp_mod, rigs, seqs, hands):
    import torch
    from umetrack_torch.ops.resample import bilinear_sample_pool_plain
    from umetrack_torch.tracker import TrackerConfig
    from umetrack_torch.tracker.tracker import pool_warp_operands

    warp_pool = wp_mod.warp_pool
    pool, coords, src = pool_warp_operands(TrackerConfig(), rigs, seqs, hands)
    log(f"[kernel] bench shape: pool {tuple(pool.shape)} {pool.dtype}, "
        f"coords {tuple(coords.shape)}, src {tuple(src.shape)}")
    out_k = warp_pool(pool, coords, src)
    out_p = bilinear_sample_pool_plain(pool, coords, src)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    check(err <= KERNEL_ATOL, f"kernel vs plain at bench shape: {err}")
    frac_valid = float((out_p != 0).float().mean())
    log(f"[kernel] bench shape max_abs_err {err:.3e} (<= {KERNEL_ATOL}), "
        f"nonzero samples {frac_valid:.3f}")
    del out_k, out_p

    edge_err = 0.0
    for i, (p, c, s) in enumerate(edge_cases("cuda")):
        ok = warp_pool(p, c, s)
        pl = bilinear_sample_pool_plain(p, c, s)
        torch.cuda.synchronize()
        e = float((ok - pl).abs().max())
        check(bool(torch.isfinite(ok).all()), f"edge case {i}: non-finite output")
        if i < 2:
            invalid = ok[0, 0, [0, 1, 2, 3, 4, 8, 9, 10]]
            check(bool((invalid == 0).all()), f"edge case {i}: invalid samples not 0")
        check(e <= KERNEL_ATOL, f"edge case {i}: kernel vs plain {e}")
        edge_err = max(edge_err, e)
    log(f"[kernel] edge cases max_abs_err {edge_err:.3e}")

    ms = median_ms(lambda: warp_pool(pool, coords, src), reps=20)
    plain_ms = median_ms(lambda: bilinear_sample_pool_plain(pool, coords, src), reps=5, warmup=1)
    taps = touched_source_bytes(pool, coords, src)
    n_pix = coords.shape[0] * coords.shape[1] * coords.shape[2]
    moved = coords.numel() * 4 + n_pix * 4 + taps
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_pix * 17 / F32_OPS_PER_S * 1e3  # ~17 f32 ops per sample
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    log(f"[kernel] warp_pool {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: coords {coords.numel() * 4 / 1e6:.1f} MB + out {n_pix * 4 / 1e6:.1f} MB "
        f"+ touched taps {taps / 1e6:.1f} MB at 3.35 TB/s), roofline share {bound_ms / ms:.3f}")
    log("[kernel] library_ms null: no single PyTorch call computes this function "
        "(grid_sample zero-pads per tap, not per floor cell, and needs a per-warp image)")
    del pool, coords, src
    return dict(max_abs_err=max(err, edge_err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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
    launches = wp_mod.warp_pool.launches
    check(res.joint_angles.shape == (t, s, 2, 22), f"angles shape {tuple(res.joint_angles.shape)}")
    check(res.wrist_xfs.shape == (t, s, 2, 4, 4), f"wrist shape {tuple(res.wrist_xfs.shape)}")
    check(bool(torch.isfinite(res.joint_angles).all() & torch.isfinite(res.wrist_xfs).all()),
          "non-finite tracker output")
    check(bool(torch.isfinite(state.temporal.mem_features).all()), "non-finite memory")
    n_valid = int(res.valid.sum())
    check(0 < n_valid, "no valid hands")
    med = sorted(times[1:])[len(times[1:]) // 2]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool_warp_operands(TrackerConfig(), rigs, seqs, hands)
    torch.cuda.synchronize()
    geom = time.perf_counter() - t0
    log(f"[slice] track_sequences_batched S={s} T={t} full ModelConfig() f32: "
        f"{med * 1e3:.1f} ms/call median of {TRACK_CALLS} (first call {times[0] * 1e3:.1f} ms), "
        f"{s * t / med:.1f} frames/s, crop geometry alone {geom * 1e3:.1f} ms, "
        f"valid hands {n_valid}/{res.valid.numel()}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    return launches


def phase_profile(model, rigs, seqs, hands, card, top=15):
    """One warmed-up ``track_sequences_batched`` call under torch.profiler:
    device time by kernel, the share of the warp kernel, and the device's
    busy share of the call's wall time (one stream, so kernels do not
    overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from umetrack_torch.tracker import HandTracker

    tracker = HandTracker(model, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tracker.track_sequences_batched(rigs, seqs, hands)
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
    warp = sum(r[0] for r in rows if "warp_pool_kernel" in r[2])
    log(f"[profile] one call: wall {wall_us / 1e3:.1f} ms, device {total / 1e3:.1f} ms, "
        f"busy share {total / wall_us:.3f}, warp_pool_kernel {warp / 1e3:.3f} ms "
        f"({warp / total:.4f} of device time) [{card}]")
    for dev, count, key in rows[:top]:
        log(f"[profile] {dev / 1e3:9.3f} ms {dev / total:6.3f} x{count:<5d} {key[:100]}")


def phase_cpu_vs_card(model_cpu, model_cuda):
    import torch
    from umetrack_torch.tracker import HandTracker
    from umetrack_torch.utils.synthetic import make_sequences

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rigs, seqs, hands = make_sequences(S_SMALL, T_SMALL, seed=100, device="cpu")
        res_cpu, _ = HandTracker(model_cpu, device="cpu").track_sequences_batched(rigs, seqs, hands)
        res_gpu, _ = HandTracker(model_cuda, device="cuda").track_sequences_batched(
            rigs.to("cuda"), seqs.to("cuda"), hands.to("cuda"))
        res_gpu = res_gpu.to("cpu")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    v = res_cpu.valid
    check(bool((v == res_gpu.valid).all()), "valid masks differ between CPU and card")
    check(bool(v.any()), "no valid hands in the CPU-vs-card run")
    da = float((res_cpu.joint_angles[v] - res_gpu.joint_angles[v]).abs().max())
    dw = float((res_cpu.wrist_xfs[v][..., :3, 3] - res_gpu.wrist_xfs[v][..., :3, 3]).abs().max())
    log(f"[cpu-vs-card] S={S_SMALL} T={T_SMALL} TF32 off: valid equal, "
        f"max angle diff {da:.3e} rad (<= 1e-3), max wrist diff {dw:.3e} mm (<= 0.1)")
    check(da <= 1e-3, f"angles differ by {da} rad")
    check(dw <= 0.1, f"wrist translations differ by {dw} mm")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    card = phase_device()
    wp_mod = phase_build()

    from umetrack_torch.models import ModelConfig, make_model
    from umetrack_torch.utils.synthetic import make_sequences

    t0 = time.perf_counter()
    rigs, seqs, hands = make_sequences(S_BENCH, T_BENCH, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[inputs] {S_BENCH} sequences x {T_BENCH} frames, images {tuple(seqs.images.shape)} "
        f"{seqs.images.dtype}, made in {time.perf_counter() - t0:.1f} s")

    kern = phase_kernel(wp_mod, rigs, seqs, hands)
    model_cuda = make_model(ModelConfig(), seed=0, device="cuda")
    launches = phase_slice(wp_mod, model_cuda, rigs, seqs, hands, card)
    phase_profile(model_cuda, rigs, seqs, hands, card)
    del rigs, seqs, hands
    torch.cuda.empty_cache()
    phase_cpu_vs_card(make_model(ModelConfig(), seed=0, device="cpu"), model_cuda)

    log(json.dumps({"kernels": [{
        "name": "warp_pool",
        "route": "cuda",
        "source": "umetrack_torch/csrc/warp_pool.cu",
        "replaces": "umetrack_tpu/ops/pallas_resample.py:243",
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
