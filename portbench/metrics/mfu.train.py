"""The work of the window's calls, counted once per call by PyTorch's FLOP
counter over the frozen reference at the cell's shapes, over the window's
seconds, as a share of the H100's dense TF32 peak (494.7 TFLOP/s at 700 W;
the card's power limit is in the result's ``device``)."""
from portbench.yardstick import PEAK_TF32_FLOPS


def read(r):
    if not r.on_card or not r.flops_per_call:
        return None
    return r.flops_per_call * r.calls / r.window_s / PEAK_TF32_FLOPS * 100.0
