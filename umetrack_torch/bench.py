"""Tracker frames/s on one card: the port's counterpart of ``bench.py``.

    python -m umetrack_torch.bench [--seqs 64] [--t 16] [--dtype bfloat16]
        [--breakdown] [--sampler kernel|plain|kernel_win|kernel_full|plain_image]
        [--no-reference] [--device cpu]

The full tracker (crop cameras from the GT pose -> one warp of every crop ->
model forward -> pose decode -> state carry) over S copies of one synthetic
4-camera sequence, merged into one ``track_sequences_batched`` call, with
seeded random weights.  The inputs are those of the JAX package's bench:
``make_labels_dict(T, rng_seed=0)`` and ``our_sequence`` stacked S times,
a zero tracker state, the weights drawn from seed 0.

After one warm-up call (on the card the eager run and the capture of the
call's CUDA graph, ``tracker/compiled.py``: the counterpart of the JAX
bench's compile), ``pipeline_depth`` calls (graph replays) are submitted
back to back on inputs already on the card (``images + i + 1`` in uint8,
which wraps), between two ``torch.cuda.synchronize()``; frames/s = S*T /
(wall / depth).  The FLOPs are counted by ``torch.utils.flop_counter`` over
one more call, run eagerly (a replay passes no dispatcher), outside the
timed window; on an H100 the line gives them as a share of the card's dense
peak for the compute dtype.  One ``[bench]`` line goes to stderr, with the
capture's ms and the graph's memory, and one JSON line to stdout:

    {"metric": "tracker_frames_per_s_per_chip", "value": N, "unit": "frames/s",
     "vs_baseline": null}

``vs_baseline`` stays null: the JAX bench's baseline runs the original
PyTorch UmeTrack on the host from a checkout of its sources beside the
repository, which this repository does not hold.  Runs on the card unless
``--device cpu`` is given; with no card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Callable

import torch

from ._device import resolve_device
from .models import ModelConfig, init_model
from .ops.warp_image import warp_image_full, warp_image_windowed
from .ops.warp_pool import warp_pool
from .tracker import TrackerConfig, TrackState
from .tracker import compiled
from .tracker.tracker import (
    _prepare_sequences_merged,
    _track_sequences_batched_eager,
    track_sequences_batched,
)
from .tracker.types import SAMPLERS
from .utils.synthetic import make_labels_dict, our_sequence

# Analytic fallback when the counter sees no FLOPs, as the JAX bench keeps
# it: model FLOPs per tracked frame (2 hands x 2 views x ~1.0 GFLOP of
# backbone per 96 x 96 crop + ~0.04 GFLOP of fusion, temporal and regressor).
MODEL_FLOPS_PER_FRAME_FALLBACK = 4.0e9
# NVIDIA H100 SXM5 dense peaks (the data sheet, no sparsity), FLOP/s.
H100_PEAK_FLOPS = {"bf16": 989.4e12, "tf32": 494.7e12, "fp32": 66.9e12}
DTYPES = ("bfloat16", "float32")
WARP_KERNELS = (warp_pool, warp_image_windowed, warp_image_full)
BREAKDOWN_REPS = 3


def peak_flops(compute_dtype: str, device: torch.device):
    """(name, FLOP/s) of the card's dense peak that the compute dtype runs
    at (f32 convolutions run in TF32 while cuDNN may use it), or None off
    an H100."""
    if device.type != "cuda" or "H100" not in torch.cuda.get_device_name(device):
        return None
    if compute_dtype == "bfloat16":
        name = "bf16"
    else:
        name = "tf32" if torch.backends.cudnn.allow_tf32 else "fp32"
    return name, H100_PEAK_FLOPS[name]


def card_name(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", f"--id={torch.cuda.current_device() if device.index is None else device.index}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip() if smi.returncode == 0 else f"nvidia-smi failed: {smi.stderr.strip()}"


def bench_inputs(t_frames: int, n_seqs: int, compute_dtype: str, device: torch.device):
    """(model, rigs, seqs, state, hands): one synthetic sequence stacked
    ``n_seqs`` times, a zero state of 2S hand rows, seed-0 weights."""
    labels, images = make_labels_dict(t_frames, rng_seed=0, device=device)
    rig, seq, hand = our_sequence(labels, images, device)
    model, _ = init_model(torch.Generator().manual_seed(0), ModelConfig(compute_dtype=compute_dtype), device)

    def stack(tree):
        return tree.map(lambda a: torch.stack([a] * n_seqs))

    state = TrackState.init(model.config, 2 * n_seqs, device=device)
    return model, stack(rig), stack(seq), state, stack(hand)


def image_variants(images: torch.Tensor, depth: int):
    """``images + i + 1`` for i < depth, in the images' uint8 (wrapping
    modulo 256, as ``jnp.uint8`` does)."""
    return [images + (i + 1) for i in range(depth)]


def count_flops(call: Callable[[], object]) -> float:
    """FLOPs of one ``call()`` as ``torch.utils.flop_counter`` counts them."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        call()
    return float(counter.get_total_flops())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_ours(t_frames=16, n_seqs=64, pipeline_depth=4, compute_dtype="bfloat16",
               breakdown=False, sampler=None, device=None) -> float:
    """Pipelined batched-tracker frames/s (see the module's docstring); the
    ``[bench]`` line goes to stderr.  ``breakdown`` also times the crop
    cameras and warps alone (``_prepare_sequences_merged``: one warm-up,
    then the mean of BREAKDOWN_REPS calls between two synchronisations)."""
    device = resolve_device(device)
    cfg = TrackerConfig(sampler=sampler)
    resolved = cfg.resolved_sampler(device)  # raises for a kernel on the CPU
    model, rigs, seqs, state, hands = bench_inputs(t_frames, n_seqs, compute_dtype, device)
    n_frames = t_frames * n_seqs
    for kernel in WARP_KERNELS:
        kernel.launches = 0

    def submit(seqs_in):
        return track_sequences_batched(model, cfg, rigs, seqs_in, state, hands, device=device)

    prep_ms = None
    if breakdown:
        def prep():
            with torch.inference_mode():
                return _prepare_sequences_merged(cfg, rigs, seqs, hands, 1, resolved)

        prep()
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(BREAKDOWN_REPS):
            prep()
        _sync(device)
        prep_ms = (time.perf_counter() - t0) / BREAKDOWN_REPS * 1e3

    submit(seqs)  # warm-up: cuDNN picks its algorithms, the graph is captured
    captured = compiled.last_capture("_sequences_batched_step")
    flops = count_flops(lambda: _track_sequences_batched_eager(
        model, cfg, rigs, seqs, state, hands, device=device)) / n_frames
    flop_source = "torch-counted" if flops > 0 else "analytic-fallback"
    if flops <= 0:
        flops = MODEL_FLOPS_PER_FRAME_FALLBACK

    variants = [dataclasses.replace(seqs, images=v) for v in image_variants(seqs.images, pipeline_depth)]
    _sync(device)
    t0 = time.perf_counter()
    for v in variants:
        submit(v)
    _sync(device)
    call_s = (time.perf_counter() - t0) / pipeline_depth

    fps = n_frames / call_s
    tflops = n_frames * flops / call_s / 1e12
    peak = peak_flops(compute_dtype, device)
    share = f" (~{100 * tflops * 1e12 / peak[1]:.1f}% of {peak[0]} peak)" if peak else ""
    prep_txt = (f"prep {prep_ms:.1f} ms (scan-ish {call_s * 1e3 - prep_ms:.1f} ms), "
                if prep_ms is not None else "")
    launches = ", ".join(f"{kernel.__name__} {kernel.launches}" for kernel in WARP_KERNELS)
    graph = (f"CUDA graph captured in {captured.capture_ms:.1f} ms, pool {captured.pool_bytes / 2**20:.1f} MiB"
             if captured else "no CUDA graph")
    print(f"[bench] dtype={compute_dtype} sampler={sampler or f'auto({resolved})'} "
          f"S={n_seqs} T={t_frames}: {prep_txt}fused {call_s * 1e3:.1f} ms, {fps:.0f} frames/s, "
          f"{tflops:.1f} TFLOP/s on {flop_source} {flops / 1e9:.3f} GFLOP/frame{share}, "
          f"{graph}, warp launches {launches} [{card_name(device)}]", file=sys.stderr, flush=True)
    return fps


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seqs", type=int, default=64)
    p.add_argument("--t", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    p.add_argument("--no-reference", action="store_true",
                   help="skip the note on the reference baseline (not in this repository)")
    p.add_argument("--breakdown", action="store_true",
                   help="also time the crop cameras and warps alone")
    p.add_argument("--sampler", default=None, choices=SAMPLERS,
                   help="the crop warp (TrackerConfig.sampler); default: the pool kernel on CUDA")
    p.add_argument("--device", default=None,
                   help="'cuda[:i]' (the default; raises without a GPU) or 'cpu'")
    args = p.parse_args(argv)

    fps = bench_ours(t_frames=args.t, n_seqs=args.seqs, compute_dtype=args.dtype,
                     breakdown=args.breakdown, sampler=args.sampler, device=args.device)
    if not args.no_reference:
        print("reference baseline skipped: it runs the original PyTorch UmeTrack, whose sources "
              "this repository does not hold", file=sys.stderr, flush=True)
    result = {
        "metric": "tracker_frames_per_s_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": None,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
