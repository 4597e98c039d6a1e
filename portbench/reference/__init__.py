"""The benchmark's plain reference: a frozen copy of the port's plain path.

Copied from ``umetrack_torch`` as it stood when the benchmark was defined,
with its imports made relative to this package and the parts that launch a
CUDA kernel, capture a graph or join a process group taken out: the model
(``models/``), the crop geometry (``geometry/``, ``kinematics/``,
``tracker/crops.py``), the plain pool sampler (``ops/resample.py``) and the
tracker's steps run eagerly (``tracker/tracker.py``).  It imports nothing
of the program, so a later change to the program cannot move it.

The comparisons run it with TF32 off (:func:`exact_float32`): float32 is
float32 here, whatever the program computes in.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_float32():
    """cuDNN's and cuBLAS's TF32 switched off for the block, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
