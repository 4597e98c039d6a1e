"""The benchmark's fixed arithmetic: the card's published peaks, the work
of a call counted on the reference, and the pool warp's byte bound.

- Peaks: NVIDIA's H100 SXM data sheet, dense rates at 700 W.  A
  utilization is stated against the TF32 peak, the precision the
  configurations run their convolutions in.
- :func:`count_flops`: ``torch.utils.flop_counter.FlopCounterMode`` over a
  call of the frozen reference at the cell's own shapes, so the count is
  the work itself and does not follow whatever implements it.
- :func:`pool_warp_bound_s`: the least time the pool warp can take on its
  operands (copied from ``chip_smoke.py::byte_bound`` and
  ``touched_source_bytes``, with the reference's ``_sample_prep``):
  coordinates read once, output written once, each distinct source byte
  the valid samples' four taps touch read once, at the card's memory rate;
  against the sample arithmetic at the f32 rate, whichever is larger.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from .reference.ops.resample import _sample_prep

PEAK_TF32_FLOPS = 494.7e12  # H100 SXM, dense TF32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
OPS_PER_SAMPLE = 17  # f32 operations of one bilinear sample, roughly


def count_flops(fn: Callable[[], object]) -> Tuple[object, int]:
    """(``fn()``, the floating-point operations it ran, by PyTorch's
    count of its convolutions and matrix products)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    return out, counter.get_total_flops()


def touched_source_bytes(pool: torch.Tensor, coords: torch.Tensor, src_idx: torch.Tensor) -> int:
    """Distinct pool bytes the valid samples' four taps read."""
    m, h, w = pool.shape
    valid, x0, y0, _, _ = _sample_prep(h, w, coords)
    base = (src_idx.to(torch.int64).reshape(-1, 1, 1) * (h * w) + y0 * w + x0)[valid]
    mask = torch.zeros(m * h * w, dtype=torch.bool, device=pool.device)
    for off in (0, 1, w, w + 1):
        mask[base + off] = True
    return int(mask.sum()) * pool.element_size()


def pool_warp_bound_s(pool: torch.Tensor, coords: torch.Tensor, src_idx: torch.Tensor) -> float:
    """The least seconds one pool-warp launch on these operands can take."""
    n_pix = coords.numel() // 2
    moved = coords.numel() * 4 + n_pix * 4 + touched_source_bytes(pool, coords, src_idx)
    return max(moved / HBM_BYTES_PER_S, n_pix * OPS_PER_SAMPLE / F32_OPS_PER_S)
