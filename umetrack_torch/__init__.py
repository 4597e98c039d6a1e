"""PyTorch / CUDA port of the UmeTrack hand tracker.

Mirrors the layout of ``umetrack_tpu`` (geometry, kinematics, ops, data,
models, tracker, apps, utils).  Plain tensor code is PyTorch; the three
bilinear warp kernels are hand-written CUDA (``csrc/warp_pool.cu`` for the
tracker's image pool, ``csrc/warp_image.cu`` for single images).
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
