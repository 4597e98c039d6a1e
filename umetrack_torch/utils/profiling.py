"""Wall-clock phase timers with throughput accounting, and a profiler
trace context.

Counterpart of ``PhaseTimers`` and ``trace`` in
``umetrack_tpu/utils/profiling.py``.  PyTorch returns before the GPU has
finished, so a phase that must include its device work names the device as
its ``barrier``: the timer synchronises it before it reads the clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


def fetch_barrier(tree=None) -> None:
    """Wait until the work queued on the CUDA devices of ``tree``'s tensors
    (nested lists, tuples, dicts and tensor dataclasses; every CUDA device
    when ``tree`` is None) has finished.  CPU tensors need no wait."""
    if tree is None:
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        return
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                visit(getattr(x, f.name))

    visit(tree)
    for device in devices:
        torch.cuda.synchronize(device)


class PhaseTimers:
    """Accumulating named wall-clock timers with item-rate reporting."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.items: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, items: int = 0, barrier: Optional[torch.device] = None):
        """Time the block; with a CUDA ``barrier`` device, wait for the work
        queued on it before the clock is read (a CPU device needs no wait)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if barrier is not None and torch.device(barrier).type == "cuda":
                torch.cuda.synchronize(barrier)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1
            self.items[name] += items

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            total = self.totals[name]
            line = f"{name}: {total:.3f}s over {self.counts[name]} calls"
            if self.items[name]:
                line += f" ({self.items[name] / max(total, 1e-9):.1f} items/s)"
            lines.append(line)
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (the CPU, and CUDA when
    there is a card) and write a Chrome trace, ``trace.json``, into
    ``log_dir`` (made if missing); does nothing when ``log_dir`` is falsy.
    A profiler that fails raises: a run asked to trace never returns
    without its trace."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
