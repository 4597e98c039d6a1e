"""Wall-clock phase timers with throughput accounting, and the program's
spans.

``PhaseTimers`` is the counterpart of the one in
``umetrack_tpu/utils/profiling.py``.  PyTorch returns before the GPU has
finished, so a phase that must include its device work names the device as
its ``barrier``: the timer synchronises it before it reads the clock.

:func:`span` and :func:`entry` mark where the program's host time goes.
They are on exactly while a ``torch.profiler`` profile runs: each is then a
profiler range named ``umetrack.<name>``, kept in the profiler's
events and on the clock of its CUPTI device events, so an idle gap of the
device can be put down to what the host was doing.  Otherwise each costs
one flag check and returns a shared null context.  A span's parent is the
span open around it on the same thread; an entry span (``entry.<name>``)
is the root of one call into the program, and the spans inside it belong
to that call.  A range opened inside a captured CUDA graph exists only at
the capture, never at a replay: spans mark the host's side of a replay.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

PREFIX = "umetrack."  # the start of every span's name in a profile
_NULL = contextlib.nullcontext()
_PROFILER = torch.autograd.profiler  # its ``_is_profiler_enabled`` is set while a profile runs
_THREAD = threading.local()  # ``root``: an entry span is open on this thread
# the range: ``record_function``'s event without its Python wrapper and op
# dispatch (about 2 instead of 16 us a range on the host)
_RANGE = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager: the profiler range ``umetrack.<name>`` while a
    profile runs, else a shared null context."""
    if not _PROFILER._is_profiler_enabled:
        return _NULL
    return _RANGE(PREFIX + name)


def entry(name: str):
    """The root span ``umetrack.entry.<name>`` of one call into the
    program, while a profile runs and no root is open on this thread (a
    call made inside another call's root belongs to that root); else a
    shared null context."""
    if not _PROFILER._is_profiler_enabled or getattr(_THREAD, "root", False):
        return _NULL
    return _root(name)


@contextlib.contextmanager
def _root(name: str):
    _THREAD.root = True
    try:
        with _RANGE(PREFIX + "entry." + name):
            yield
    finally:
        _THREAD.root = False


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
        """Time the block, which is also the span ``name``; with a CUDA
        ``barrier`` device, wait for the work queued on it before the clock
        is read (a CPU device needs no wait)."""
        with span(name):
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

