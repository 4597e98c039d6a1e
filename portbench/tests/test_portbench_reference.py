"""The frozen reference against the port's plain path on the CPU, at a tiny
model and a few rendered frames: the one place where the program and the
reference meet.  Both run the same plain operations on the CPU, so they
agree exactly; a later change to the program that alters what it computes
shows here first.

Run: ``python -m pytest portbench/tests -q`` from the checkout's root.
"""
import dataclasses

import pytest
import torch

from portbench.sides import PROGRAM, REFERENCE, side
from portbench.traffic import call_frames, generic_hand, render_recording
from portbench.weights import draw_flax_init

SMALL = dict(start_planes=8, backbone_blocks=(1, 1, 1, 1), n_image_feature_channels=12,
             n_memory_channels=6)


@pytest.fixture(scope="module")
def recording():
    torch.manual_seed(0)
    return render_recording(2**31 + 11, 2, 3, ["separate", "hand_hand"], [0.85, 1.15], True, "cpu")


@pytest.fixture(scope="module")
def sides():
    return side(PROGRAM), side(REFERENCE)


def models(sides, compute_dtype="float32"):
    """Both sides' models at the frozen reference's fields, cut by SMALL:
    the program's ``ModelConfig`` takes each of them, and a field it adds
    for another architecture keeps its default."""
    port, ref = sides
    config = {"model": {**dataclasses.asdict(ref.models.ModelConfig()), **SMALL,
                        "compute_dtype": compute_dtype}}
    m_ref = draw_flax_init(ref.models.UmeTrackNet(ref.model_config(config)), 7).eval()
    m_port = port.models.UmeTrackNet(port.model_config(config)).eval()
    m_port.load_state_dict(m_ref.state_dict())
    return m_port, m_ref


def tracker_configs(sides):
    port, ref = sides
    fields = {f.name: getattr(ref.tracker.TrackerConfig(), f.name)
              for f in dataclasses.fields(ref.tracker.TrackerConfig)}
    return port.tracker.TrackerConfig(**fields, sampler="plain"), ref.tracker.TrackerConfig(**fields)


def assert_same(a, b):
    for name in ("joint_angles", "wrist_xfs", "valid", "n_views", "predicted_scales"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=name)


def assert_same_state(a, b):
    torch.testing.assert_close(a.temporal.mem_features, b.temporal.mem_features, rtol=0, atol=0)
    torch.testing.assert_close(a.temporal.prev_extrinsics, b.temporal.prev_extrinsics, rtol=0, atol=0)
    torch.testing.assert_close(a.valid_history, b.valid_history, rtol=0, atol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_batched_known_carried_state(recording, sides, compute_dtype):
    port, ref = sides
    m_port, m_ref = models(sides, compute_dtype)
    c_port, c_ref = tracker_configs(sides)
    idx = call_frames([0, 1], 2)
    state = port.zero_state(m_port, 4, "cpu")
    for _ in range(2):  # a call from zero, then one from the carried state
        got, got_state = port.tracker.track_sequences_batched(
            m_port, c_port, port.rig(recording), port.frames(recording, slice(None), idx), state,
            port.hand_model(recording.hand), 1, device="cpu")
        want, want_state = ref.tracker.track_sequences_batched(
            m_ref, c_ref, ref.rig(recording), ref.frames(recording, slice(None), idx),
            ref.state(state), ref.hand_model(recording.hand), 1)
        assert_same(got, want)
        assert_same_state(got_state, want_state)
        state = got_state


def test_unknown_protocol(recording, sides):
    port, ref = sides
    m_port, m_ref = models(sides)
    c_port, c_ref = tracker_configs(sides)
    idx = call_frames([2, -1], 2)
    s = recording.n_sequences
    got_scales = port.tracker.calibrate_sequences_batched(
        m_port, c_port, port.rig(recording), port.frames(recording, slice(None), idx),
        port.zero_state(m_port, 2 * s, "cpu"), port.hand_model(recording.hand), 3, 2, device="cpu")
    want_scales = ref.tracker.calibrate_sequences_batched(
        m_ref, c_ref, ref.rig(recording), ref.frames(recording, slice(None), idx),
        ref.zero_state(m_ref, 2 * s, "cpu"), ref.hand_model(recording.hand), 3, 2)
    torch.testing.assert_close(got_scales, want_scales, rtol=0, atol=0)
    results = []
    for sd in sides:
        generic = sd.hand_model(generic_hand("cpu"))
        skel = sd.hand.scaled_hand_model(generic.map(lambda a: a.expand(s, *a.shape)), want_scales)
        model, config = (m_port, c_port) if sd is sides[0] else (m_ref, c_ref)
        kwargs = {"device": "cpu"} if sd is sides[0] else {}
        results.append(sd.tracker.track_sequences_batched(
            model, config, sd.rig(recording), sd.frames(recording, slice(None), idx),
            sd.zero_state(model, 2 * s, "cpu"), sd.hand_model(recording.hand), 1, skel, **kwargs))
    assert_same(results[0][0], results[1][0])
    assert_same_state(results[0][1], results[1][1])


def test_track_frame(recording, sides):
    port, ref = sides
    m_port, m_ref = models(sides)
    c_port, c_ref = tracker_configs(sides)
    state = port.zero_state(m_port, 2, "cpu")
    for f in range(recording.n_frames):
        got, got_state = port.tracker.track_frame(
            m_port, c_port, port.rig(recording, 0), port.frames(recording, 0, f), state,
            port.hand_model(recording.hand, 0), 1, known=True, device="cpu")
        want, want_state = ref.tracker.track_frame(
            m_ref, c_ref, ref.rig(recording, 0), ref.frames(recording, 0, f), ref.state(state),
            ref.hand_model(recording.hand, 0), 1, True)
        assert_same(got, want)
        assert_same_state(got_state, want_state)
        state = got_state


def test_pool_warp_operands(recording, sides):
    port, ref = sides
    c_port, c_ref = tracker_configs(sides)
    idx = call_frames([0, 1], 2)
    for min_num_crops in (1, 2):
        got = port.tracker.tracker.pool_warp_operands(
            c_port, port.rig(recording), port.frames(recording, slice(None), idx),
            port.hand_model(recording.hand), min_num_crops)
        want = ref.tracker.tracker.pool_warp_operands(
            c_ref, ref.rig(recording), ref.frames(recording, slice(None), idx),
            ref.hand_model(recording.hand), min_num_crops)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
