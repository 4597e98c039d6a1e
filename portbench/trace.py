"""The benchmark's own spans and the device trace of a traced run.

:class:`Spans` times the host's calls into each layer of the program from
the benchmark's side (the program has no spans of its own yet): a named
span around a call, its durations kept in memory.  While a device trace is
being taken, each span is also a ``torch.profiler.record_function`` range,
so the trace can say what the host was doing while the device sat idle.

:func:`device_trace` profiles a stretch of work with ``torch.profiler``
(CUPTI) and reduces it to what the metrics read: every device operation
(kernels, copies, sets) with its name and interval, the traced window's
bounds, the union of the operations' intervals (the busy time), and the
idle gaps named by the innermost span the host was in.  Kinds of kernel by
a piece of their name follow ``chip_smoke.py::KERNEL_KINDS``, copied here.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

PREFIX = "portbench."
OUTSIDE = "harness (outside every span)"

# Kinds of device operation by a piece of their name (lower case), first
# match wins.  cuDNN's convolutions come as implicit GEMMs, sgemm
# convolutions, Winograd or FFT (the FFT's complex GEMMs are ``gemm_cf32``).
KERNEL_KINDS = (
    ("warp_pool", ("warp_pool_kernel",)),
    ("layout", ("nchwtonhwc", "nhwctonchw")),
    ("conv", ("fprop", "dgrad", "wgrad", "convolve", "conv2d", "implicit_gemm", "winograd",
              "fft", "gemm_cf32")),
    ("BN", ("bn_fw", "bn_bw", "batch_norm")),
    ("ReLU", ("clamp", "relu", "threshold")),
    ("add", ("_add<", "add_kernel")),
    ("max-pool", ("max_pool",)),
    ("copy/cast", ("copy", "memcpy", "memset")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    return next((kind for kind, parts in KERNEL_KINDS if any(p in low for p in parts)), "other")


class Spans:
    """Named host spans: ``with spans("entry"): ...``.  Durations in
    seconds by name; while ``profiling`` each span is a profiler range too."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = torch.profiler.record_function(PREFIX + name) if self.profiling else contextlib.nullcontext()
        with rng:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name].append(time.perf_counter() - t0)


@dataclasses.dataclass
class DeviceTrace:
    """One traced window: device operations ``(name, start_s, end_s)``
    relative to the window's start, the window's length, and the host spans
    ``(name, start_s, end_s)`` on the same clock."""

    ops: List[Tuple[str, float, float]]
    window_s: float
    spans: List[Tuple[str, float, float]]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the operations' intervals, clipped to the window."""
        merged: List[List[float]] = []
        for _, s, e in sorted(self.ops, key=lambda op: op[1]):
            s, e = max(s, 0.0), min(e, self.window_s)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def seconds_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.ops:
            out[kind_of(name)] += e - s
        return dict(out)

    def seconds_of(self, piece: str) -> Tuple[float, int]:
        """(total seconds, count) of the operations whose name holds ``piece``."""
        hits = [e - s for name, s, e in self.ops if piece in name]
        return sum(hits), len(hits)

    def idle_by_span(self) -> Dict[str, float]:
        """Idle seconds of the device (gaps between busy intervals inside
        the window) by the innermost host span open when each gap began."""
        busy = self.busy_intervals()
        gaps = []
        edge = 0.0
        for s, e in busy:
            if s > edge:
                gaps.append((edge, s))
            edge = e
        if edge < self.window_s:
            gaps.append((edge, self.window_s))
        starts = sorted(self.spans, key=lambda sp: sp[1])
        keys = [sp[1] for sp in starts]
        out: Dict[str, float] = collections.defaultdict(float)
        for g0, g1 in gaps:
            name, best = OUTSIDE, None
            for sp in starts[:bisect.bisect_right(keys, g0)]:
                if sp[2] > g0 and (best is None or sp[1] >= best):
                    name, best = sp[0], sp[1]
            out[name] += g1 - g0
        return dict(out)


def device_trace(work: Callable[[], None], spans: Spans) -> DeviceTrace:
    """Run ``work`` under ``torch.profiler`` (CPU and CUDA activities), the
    device synchronised before and after, and reduce the trace."""
    from torch.profiler import ProfilerActivity, profile

    window = PREFIX + "traced_window"
    spans.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            with torch.profiler.record_function(window):
                work()
                torch.cuda.synchronize()
    finally:
        spans.profiling = False
    events = prof.profiler.kineto_results.events()
    host = [(e.name(), e.start_ns(), e.end_ns()) for e in events
            if e.device_type() == torch.autograd.DeviceType.CPU and e.name().startswith(PREFIX)]
    labels = {name for name, _, _ in host}
    t0, t1 = next((s, e) for name, s, e in host if name == window)
    ops = [(e.name(), (e.start_ns() - t0) * 1e-9, (e.end_ns() - t0) * 1e-9) for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA and e.name() not in labels
           and not e.is_user_annotation()]
    host_spans = [(name[len(PREFIX):], (s - t0) * 1e-9, (e - t0) * 1e-9)
                  for name, s, e in host if name != window]
    return DeviceTrace(ops=ops, window_s=(t1 - t0) * 1e-9, spans=host_spans)


def breakdown(trace: Optional[DeviceTrace]) -> Optional[dict]:
    """The result line's ``breakdown``: device seconds by kind of operation
    and idle seconds by host span, each largest first, at most 10."""
    if trace is None:
        return None

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(trace.seconds_by_kind()), "idle_gaps": top(trace.idle_by_span())}
