"""PyTorch / CUDA port of the UmeTrack hand tracker.

Mirrors the layout of ``umetrack_tpu`` (geometry, kinematics, ops, models,
tracker, utils).  Plain tensor code is PyTorch; the one image-pool warp
kernel of the main path is hand-written CUDA (``csrc/warp_pool.cu``).
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
