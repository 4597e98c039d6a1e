"""The program's own spans in a traced window, and what they say.

While a ``torch.profiler`` profile runs, the program (``umetrack_torch``)
opens profiler ranges named ``umetrack.<span>`` (its
``utils/profiling.py``): a root ``entry.<function>`` for each call into it
(``track_frame``, ``track_sequences_batched``,
``calibrate_sequences_batched``, ``resident_train_step``, ...) and inside
it ``to_device`` (host tensors moved to the card), ``step.key``,
``step.stage``, ``step.replay``, ``step.outputs`` (a compiled step's key,
its copies into the static inputs, the replay's launch, the clones of its
outputs) or ``step.capture``.  Its counter ``tracker.HOST_COPIES`` counts
the entry's moves (``calls``) and the host tensors they copied (``copies``).

The reductions below read those spans as ``(name, start s, end s)`` on a
traced window's clock, the prefix taken off their names:

- :func:`calls`: the program's spans grouped by their root entry span;
- :func:`median_per_call_ms`: the median over the calls of the time in a
  span or a set of spans, counting only calls wholly inside the window;
- :func:`idle_by_program_span`: idle seconds of the device by the
  innermost program span open when each gap began, by the rule of
  ``DeviceTrace.idle_by_span``;
- :func:`idle_in_program_share`: the share of idle time that began inside
  a program span.

``trace.device_trace`` does not keep the program's events yet: the
readers of span metrics wait for it to keep them beside ``spans`` (in
a ``DeviceTrace.program_spans``).  A program without spans (an older one)
gives an empty list: the medians and the share are then ``None``, and all
idle time lies outside the program.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import OUTSIDE, DeviceTrace

Span = Tuple[str, float, float]  # (name, start s, end s) on the traced window's clock
ROOT = "entry."  # the program's root spans' names start with this
OUTSIDE_PROGRAM = "outside the program"
PREP = ("step.key", "step.stage", "step.outputs")  # a compiled step's host work around its replay


def calls(spans: Sequence[Span], window_s: float) -> List[Tuple[Span, List[Span]]]:
    """Each root entry span wholly inside the window ``[0, window_s]``, in
    order of start, with the other program spans that lie inside it."""
    roots = sorted((s for s in spans if s[0].startswith(ROOT) and s[1] >= 0.0 and s[2] <= window_s),
                   key=lambda s: s[1])
    rest = sorted((s for s in spans if not s[0].startswith(ROOT)), key=lambda s: s[1])
    starts = [s[1] for s in rest]
    out = []
    for root in roots:
        lo, hi = bisect.bisect_left(starts, root[1]), bisect.bisect_right(starts, root[2])
        out.append((root, [s for s in rest[lo:hi] if s[2] <= root[2]]))
    return out


def median_per_call_ms(spans: Sequence[Span], window_s: float, names: Sequence[str]) -> Optional[float]:
    """The median over the calls wholly inside the window that hold a span
    named in ``names`` of those spans' summed host time, in ms; None if no
    call holds one."""
    per_call = [sum(e - s for name, s, e in inner if name in names)
                for _, inner in calls(spans, window_s) if any(sp[0] in names for sp in inner)]
    return statistics.median(per_call) * 1e3 if per_call else None


def idle_by_program_span(trace: DeviceTrace, spans: Sequence[Span]) -> Dict[str, float]:
    """Idle seconds of the device by the innermost program span open when
    each gap began, else :data:`OUTSIDE_PROGRAM`."""
    idle = dataclasses.replace(trace, spans=list(spans)).idle_by_span()
    out: Dict[str, float] = collections.defaultdict(float)
    for name, seconds in idle.items():
        out[OUTSIDE_PROGRAM if name == OUTSIDE else name] += seconds
    return dict(out)


def idle_in_program_share(trace: DeviceTrace, spans: Sequence[Span]) -> Optional[float]:
    """The share (%) of the window's idle seconds whose gap began inside a
    program span; None without program spans or without idle time."""
    if not spans:
        return None
    idle = idle_by_program_span(trace, spans)
    total = sum(idle.values())
    if total <= 0:
        return None
    return (total - idle.get(OUTSIDE_PROGRAM, 0.0)) / total * 100.0


def h2d_copies_per_call() -> Optional[float]:
    """Host tensors the program's entry copied to the card per call, over
    the process (its ``tracker.HOST_COPIES``); None for a program without
    the counter or before any call."""
    try:
        from umetrack_torch.tracker.tracker import HOST_COPIES
    except ImportError:
        return None
    return HOST_COPIES["copies"] / HOST_COPIES["calls"] if HOST_COPIES["calls"] else None
