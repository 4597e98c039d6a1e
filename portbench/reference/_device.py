"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU explicitly.
With no GPU and no explicit ``"cpu"`` they raise: there is no silent
fallback, so a CPU run is never mistaken for a GPU run.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` or ``"cuda[:i]"`` -> a CUDA device (raises if there is none);
    ``"cpu"`` -> the CPU.  Anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def device_constant(values: Sequence[float], dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` made by fill
    kernels on the device instead of a copy from host memory, which waits
    for the device and which a CUDA graph cannot capture."""
    return torch.stack([torch.full((), float(v), dtype=dtype, device=device) for v in values])
