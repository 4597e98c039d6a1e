"""``portbench/inside.py`` on a synthetic trace: the program's spans grouped
by their root entry span, the medians a call, the idle gaps put down to the
innermost program span, and the readers of what it reads returning nothing
without a trace.

Run: ``python -m pytest portbench/tests -q`` from the checkout's root.
"""
import pytest

from portbench import harness, inside
from portbench.harness import Readings
from portbench.trace import DeviceTrace

# two calls wholly inside a 10 s window and a third cut by its end; a span
# outside every call; times in seconds on the window's clock
SPANS = [
    ("entry.track_frame", 1.0, 3.0),
    ("to_device", 1.0, 1.5),
    ("step.key", 1.5, 1.6),
    ("step.stage", 1.6, 1.7),
    ("step.replay", 1.7, 2.7),
    ("step.outputs", 2.7, 2.9),
    ("entry.track_frame", 4.0, 5.0),
    ("to_device", 4.0, 4.1),
    ("step.key", 4.1, 4.2),
    ("step.capture", 4.2, 5.0),
    ("entry.track_frame", 9.0, 10.5),
    ("step.replay", 9.5, 10.2),
    ("step.replay", 6.0, 6.5),
]
# the device busy over [0, 1.2], [2.0, 4.5], [5.5, 9.6]: gaps begin at 1.2
# (inside to_device), 4.5 (inside step.capture), 9.6 (inside step.replay)
TRACE = DeviceTrace(ops=[("k", 0.0, 1.2), ("k", 2.0, 4.5), ("k", 5.5, 9.6)], window_s=10.0,
                    spans=[("entry", 0.5, 9.9)])


def test_calls_group_the_spans_by_their_root_inside_the_window():
    found = inside.calls(SPANS, TRACE.window_s)
    assert [root for root, _ in found] == [("entry.track_frame", 1.0, 3.0), ("entry.track_frame", 4.0, 5.0)]
    assert [s[0] for s in found[0][1]] == ["to_device", "step.key", "step.stage", "step.replay",
                                           "step.outputs"]
    assert [s[0] for s in found[1][1]] == ["to_device", "step.key", "step.capture"]
    assert inside.calls([], 10.0) == []


def test_medians_a_call_count_the_calls_that_hold_the_spans():
    assert inside.median_per_call_ms(SPANS, 10.0, ("step.replay",)) == pytest.approx(1000.0)
    assert inside.median_per_call_ms(SPANS, 10.0, ("to_device",)) == pytest.approx(300.0)
    # key + stage + outputs: 400 ms in the first call, 100 ms (the key) in the second
    assert inside.median_per_call_ms(SPANS, 10.0, inside.PREP) == pytest.approx(250.0)
    assert inside.median_per_call_ms(SPANS, 10.0, ("step.nothing",)) is None
    assert inside.median_per_call_ms([], 10.0, ("step.replay",)) is None
    assert inside.median_per_call_ms(SPANS, 10.0, ("step.capture",)) == pytest.approx(800.0)


def test_idle_is_put_down_to_the_innermost_program_span():
    idle = inside.idle_by_program_span(TRACE, SPANS)
    assert idle == pytest.approx({"to_device": 0.8, "step.capture": 1.0, "step.replay": 0.4})
    # the benchmark's own rule, untouched: every gap began inside its "entry"
    assert TRACE.idle_by_span() == pytest.approx({"entry": 2.2})
    late = DeviceTrace(ops=[("k", 0.0, 3.5)], window_s=4.0, spans=[])
    assert inside.idle_by_program_span(late, SPANS) == pytest.approx({inside.OUTSIDE_PROGRAM: 0.5})
    assert inside.idle_in_program_share(TRACE, SPANS) == pytest.approx(100.0)
    assert inside.idle_in_program_share(late, SPANS) == pytest.approx(0.0)
    assert inside.idle_in_program_share(TRACE, []) is None


def test_the_program_names_its_spans_and_counts_its_copies():
    from umetrack_torch.tracker import tracker
    from umetrack_torch.utils.profiling import PREFIX

    assert PREFIX == "umetrack."
    saved = dict(tracker.HOST_COPIES)
    try:
        tracker.HOST_COPIES.clear()
        assert inside.h2d_copies_per_call() is None
        tracker.HOST_COPIES.update(calls=4, copies=20)
        assert inside.h2d_copies_per_call() == 5.0
    finally:
        tracker.HOST_COPIES.clear()
        tracker.HOST_COPIES.update(saved)


@pytest.mark.parametrize("metric", ["h2d_copies_per_call.stream"])
def test_readers_give_nothing_without_a_trace(metric):
    r = Readings(cell="known.stream", on_card=False, setup_s=1.0, window_s=1.0, units=1, calls=1,
                 spans={}, captures=0)
    assert harness.load_reader(metric)(r) is None
