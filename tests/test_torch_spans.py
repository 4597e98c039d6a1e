"""The port's spans and host-copy counter (``umetrack_torch/utils/profiling.py``,
``tracker/tracker.py::HOST_COPIES``) on the CPU: no profiler range while no
profile runs; under a CPU profile, a ``track_frame`` through the stand-in
for CUDA graphs of ``test_torch_compiled.py`` records its entry, the move to
the device and the compiled step's key, staging, replay and outputs, nested
and in order, or its capture on a first call; an entry inside another
entry's root adds no root; the counter counts only the leaves that cross
from the host; ``PhaseTimers.phase`` is a span too."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_compiled import FakeGraphs
from umetrack_torch._tree import TensorTree
from umetrack_torch.models import ModelConfig, UmeTrackNet
from umetrack_torch.tracker import HandTracker, compiled
from umetrack_torch.tracker import tracker as port_tracker
from umetrack_torch.utils import profiling
from umetrack_torch.utils.profiling import PhaseTimers, entry, span
from umetrack_torch.utils.synthetic import make_sequence
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(start_planes=8, backbone_blocks=(1, 1, 1, 1), n_image_feature_channels=12,
             n_memory_channels=6)
STEP = ["step.key", "step.stage", "step.replay", "step.outputs"]


@pytest.fixture(scope="module")
def frames():
    torch.manual_seed(0)
    tracker = HandTracker(UmeTrackNet(ModelConfig(**SMALL)), device="cpu")
    rig, seq, hand = make_sequence(2, seed=3, device="cpu")
    return tracker, rig, [seq.map(lambda a, i=i: a[i]) for i in range(2)], hand


@pytest.fixture
def fake_graphs(monkeypatch):
    compiled.release()
    fake = FakeGraphs()
    monkeypatch.setattr(compiled, "GRAPHS", fake)
    yield fake
    compiled.release()


def _spans(run):
    """(name, start ns, end ns) of the program's spans recorded while
    ``run()`` runs under a CPU profile, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return sorted(((e.name()[len(profiling.PREFIX):], e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(profiling.PREFIX)), key=lambda s: s[1])


def _inside(outer, inner) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spans_off_open_no_profiler_range(frames, fake_graphs, monkeypatch):
    """No profile: every span and entry is the one shared null context, and
    a tracked frame (captured, then replayed) opens no range."""
    assert span("x") is span("y") is entry("z") is profiling._NULL

    def no_range(*args, **kwargs):
        raise AssertionError("a profiler range was opened with no profile running")

    monkeypatch.setattr(profiling, "_RANGE", no_range)
    tracker, rig, obs, hand = frames
    for frame in obs:
        tracker.track_frame(rig, frame, tracker.init_state(), hand)
    assert len(fake_graphs.graphs) == 1 and fake_graphs.graphs[0].replays == 1
    with PhaseTimers().phase("track"):
        pass


def test_track_frame_replay_records_its_spans_nested_and_in_order(frames, fake_graphs):
    tracker, rig, obs, hand = frames
    tracker.track_frame(rig, obs[0], tracker.init_state(), hand)  # captured, outside the profile
    spans = _spans(lambda: tracker.track_frame(rig, obs[1], tracker.init_state(), hand))
    assert [s[0] for s in spans] == ["entry.track_frame", "to_device"] + STEP
    root, rest = spans[0], spans[1:]
    assert all(_inside(root, s) for s in rest)
    assert all(a[2] <= b[1] for a, b in zip(rest, rest[1:]))  # one after another
    assert fake_graphs.graphs[0].replays == 1


def test_a_first_call_records_the_capture(frames, fake_graphs):
    tracker, rig, obs, hand = frames
    spans = _spans(lambda: tracker.track_frame(rig, obs[0], tracker.init_state(), hand))
    assert [s[0] for s in spans] == ["entry.track_frame", "to_device", "step.key", "step.capture"]
    assert all(_inside(spans[0], s) for s in spans[1:])
    assert len(fake_graphs.graphs) == 1 and fake_graphs.graphs[0].replays == 0


@pytest.mark.parametrize("eager", [False, True])
def test_an_entry_called_without_a_name_takes_its_steps(frames, fake_graphs, eager):
    """``_entry(step, model, device, trees, **static)``, the order callers
    outside the tracker use, runs the step (graphed or its eager form) and
    names the root after the step's function."""
    tracker, rig, obs, hand = frames
    step = port_tracker._FRAME.eager if eager else port_tracker._FRAME

    def run():
        return port_tracker._entry(step, tracker.model, "cpu",
                                   dict(rig=rig, obs=obs[0], state=tracker.init_state(), hand_model_mm=hand),
                                   config=tracker.config, min_num_crops=1, known=True)

    expected, _ = tracker.track_frame(rig, obs[0], tracker.init_state(), hand)
    spans = _spans(run)
    assert spans[0][0] == "entry." + port_tracker._FRAME.name
    got, _ = run()
    torch.testing.assert_close(got.joint_angles, expected.joint_angles, rtol=0, atol=0)


def test_an_entry_inside_a_root_opens_no_second_root():
    """The root is the outermost entry on the thread (a train step inside
    the resident trainer's entry); it closes on an error too."""
    def run():
        with entry("outer"):
            with entry("inner"), span("work"):
                pass
        with pytest.raises(ValueError), entry("failing"):
            raise ValueError
        with entry("after"):
            pass

    spans = _spans(run)
    assert [s[0] for s in spans] == ["entry.outer", "work", "entry.failing", "entry.after"]
    assert _inside(spans[0], spans[1])


@dataclasses.dataclass
class Pair(TensorTree):
    a: torch.Tensor
    b: torch.Tensor


class OneWeight(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(2))


def test_host_copies_count_only_the_leaves_that_cross(monkeypatch):
    """Each move is a call; a host leaf moved to another device is a copy,
    a leaf already there or a move on the host is not.  The ``meta``
    device stands in for the card."""
    monkeypatch.setattr(port_tracker, "resolve_device", torch.device)
    counts = port_tracker.HOST_COPIES
    on_host = Pair(torch.zeros(2), torch.ones(3))
    mixed = Pair(torch.zeros(2), torch.empty(3, device="meta"))
    calls, copies = counts["calls"], counts["copies"]
    device, moved = port_tracker._on_device(OneWeight().to("meta"), "meta", on_host, None, mixed)
    assert device.type == "meta" and moved[1] is None
    assert all(t.device.type == "meta" for tree in (moved[0], moved[2]) for t in (tree.a, tree.b))
    assert (counts["calls"] - calls, counts["copies"] - copies) == (1, 3)
    port_tracker._on_device(OneWeight(), "cpu", on_host, mixed.map(lambda t: torch.zeros(t.shape)))
    assert (counts["calls"] - calls, counts["copies"] - copies) == (2, 3)


def test_a_tracked_frame_counts_its_move(frames):
    tracker, rig, obs, hand = frames
    calls, copies = port_tracker.HOST_COPIES["calls"], port_tracker.HOST_COPIES["copies"]
    tracker.track_frame(rig, obs[0], tracker.init_state(), hand)
    assert port_tracker.HOST_COPIES["calls"] == calls + 1
    assert port_tracker.HOST_COPIES["copies"] == copies  # on the CPU nothing crosses


def test_phase_timers_open_their_span():
    timers = PhaseTimers()

    def run():
        with timers.phase("decode", items=3):
            with span("inner"):
                pass

    spans = _spans(run)
    assert [s[0] for s in spans] == ["decode", "inner"] and _inside(spans[0], spans[1])
    assert timers.counts["decode"] == 1 and timers.items["decode"] == 3
