"""Port parity for the streaming and unknown-skeleton tracker:
``track_frame`` (both heads) looped against ``track_sequence`` inside the
port, and ``track_frame``, ``predict_scales_sequence``,
``calibrate_sequence`` and ``calibrate_sequences_batched`` of
``umetrack_torch`` against the JAX tracker (pool kernel in interpret mode),
same weights, same synthetic sequence with a confidence dropout in
mid-sequence, small config, f32 on the CPU."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import synthetic
from umetrack_tpu.models import init_model, make_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.models.umetrack import TemporalState as JTemporalState
from umetrack_tpu.tracker import HandTracker as JHandTracker
from umetrack_tpu.tracker import TrackerConfig as JTrackerConfig
from umetrack_tpu.tracker.tracker import calibrate_sequences_batched as jcalibrate_batched
from umetrack_tpu.tracker.types import TrackState as JTrackState
from umetrack_torch.kinematics.hand import stack_hand_models
from umetrack_torch.models import ModelConfig, UmeTrackNet, from_flax_variables
from umetrack_torch.tracker import HandTracker, TrackerConfig
from umetrack_torch.tracker import tracker as port_tracker
from umetrack_torch.utils.synthetic import our_sequence
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
T_FRAMES = 7  # hand 1's confidence drops out at frames 2-4
ANGLE_TOL, WRIST_TOL_MM, SCALE_TOL = 1e-3, 0.1, 2e-3  # tests/test_tracker.py:215,356-360
# track_frame against the hoisted scan: tests/test_tracker.py:269-270
LOOP_ANGLE_TOL, LOOP_WRIST_TOL_MM = 1e-4, 0.02


@pytest.fixture(scope="module")
def setup():
    jcfg = JModelConfig(**SMALL)
    jvars = jax.jit(lambda key: init_model(key, jcfg)[1])(jax.random.PRNGKey(5))
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars)
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.random(a.shape) * 0.2).astype(np.float32), variables["batch_stats"]
    )
    # flax starts every bias at 0, and the scale head then answers exp(~0):
    # move the weights off their start so that the predicted scales vary
    variables["params"] = jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.05).astype(np.float32), variables["params"]
    )
    cfg = ModelConfig(**SMALL)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    labels, images = synthetic.make_labels_dict(T_FRAMES, rng_seed=13, render=False)
    conf = np.asarray(labels["hand_confidences"])
    assert conf[0].all() and not conf[3, 1] and conf[-1].all()
    return dict(
        jtracker=JHandTracker(
            make_model(jcfg), jax.tree_util.tree_map(jnp.asarray, variables),
            JTrackerConfig(sampler="pallas_pool"),
        ),
        jseq=synthetic.our_sequence(labels, images),
        tracker=HandTracker(model, device="cpu"),
        seq=our_sequence(labels, images, "cpu"),
    )


def _loop(tracker, rig, seq, hand, step):
    """``step`` per frame with the carry threaded; leaves stacked over T."""
    state, outs = tracker.init_state(), []
    for i in range(T_FRAMES):
        res, state = step(rig, seq.map(lambda a: a[i]), state, hand)
        outs.append(res)
    return outs, state


def _jloop(jtracker, jrig, jseq, jhand, step):
    state, outs = jtracker.init_state(), []
    for i in range(T_FRAMES):
        res, state = step(jrig, jax.tree_util.tree_map(lambda a: a[i], jseq), state, jhand)
        outs.append(res)
    return outs, state


def _stack(outs, name):
    return np.stack([np.asarray(getattr(o, name)) for o in outs])


def _check_against(outs, ref_angles, ref_wrists, ref_valid, atol_a, atol_w):
    v = np.asarray(ref_valid)
    np.testing.assert_array_equal(_stack(outs, "valid"), v)
    assert v.any() and not v.all()
    np.testing.assert_allclose(_stack(outs, "joint_angles")[v], np.asarray(ref_angles)[v], atol=atol_a)
    np.testing.assert_allclose(
        _stack(outs, "wrist_xfs")[v][..., :3, 3], np.asarray(ref_wrists)[v][..., :3, 3], atol=atol_w
    )
    return v


def test_track_frame_loop_equals_track_sequence_known(setup):
    """The gate from the carried state (per step) and the gate from the
    shifted validity run (hoisted scan) agree: first frame, dropout and
    recovery included."""
    tracker = setup["tracker"]
    rig, seq, hand = setup["seq"]
    ref, ref_state = tracker.track_sequence(rig, seq, hand)
    outs, state = _loop(tracker, rig, seq, hand, tracker.track_frame)
    _check_against(outs, ref.joint_angles, ref.wrist_xfs, ref.valid, LOOP_ANGLE_TOL, LOOP_WRIST_TOL_MM)
    assert all(o.predicted_scales is None for o in outs)
    np.testing.assert_array_equal(state.valid_history.numpy(), ref_state.valid_history.numpy())
    np.testing.assert_allclose(
        state.temporal.mem_features.numpy(), ref_state.temporal.mem_features.numpy(), atol=1e-4
    )
    np.testing.assert_allclose(
        state.temporal.prev_extrinsics.numpy(), ref_state.temporal.prev_extrinsics.numpy(), atol=1e-6
    )
    # a one-frame sequence == the first streaming step
    res1, _ = tracker.track_sequence(rig, seq.map(lambda a: a[:1]), hand)
    np.testing.assert_allclose(res1.joint_angles[0].numpy(), outs[0].joint_angles.numpy(), atol=LOOP_ANGLE_TOL)


def test_track_frame_loop_equals_hoisted_scan_scale_head(setup):
    tracker = setup["tracker"]
    rig, seq, hand = setup["seq"]
    scales, valid, ref_state = tracker.predict_scales(rig, seq, hand)
    outs, state = _loop(tracker, rig, seq, hand, tracker.track_frame_and_calibrate_scale)
    v = valid.numpy()
    np.testing.assert_array_equal(_stack(outs, "valid"), v)
    assert v.any() and not v.all()
    np.testing.assert_allclose(_stack(outs, "predicted_scales")[v], scales.numpy()[v], atol=1e-4)
    np.testing.assert_allclose(
        state.temporal.mem_features.numpy(), ref_state.temporal.mem_features.numpy(), atol=1e-4
    )


def test_memory_gate_follows_the_carried_state(setup):
    """The gate really is ``valid_history & hand_valid``: a state that says
    "valid last frame" changes the result against a fresh state, and
    ``enable_memory=False`` makes the two equal."""
    tracker = setup["tracker"]
    rig, seq, hand = setup["seq"]
    obs = seq.map(lambda a: a[1])
    _, warm = tracker.track_frame(rig, seq.map(lambda a: a[0]), tracker.init_state(), hand)
    assert warm.valid_history.all()
    with_memory, _ = tracker.track_frame(rig, obs, warm, hand)
    fresh, _ = tracker.track_frame(rig, obs, tracker.init_state(), hand)
    assert (with_memory.joint_angles - fresh.joint_angles).abs().max() > 1e-6
    off = HandTracker(tracker.model, TrackerConfig(enable_memory=False), device="cpu")
    a, _ = off.track_frame(rig, obs, warm, hand)
    b, _ = off.track_frame(rig, obs, off.init_state(), hand)
    assert torch.equal(a.joint_angles, b.joint_angles)


@pytest.mark.parametrize("known", [True, False], ids=["known", "scale_head"])
def test_track_frame_matches_jax(setup, known):
    tracker, jtracker = setup["tracker"], setup["jtracker"]
    step = tracker.track_frame if known else tracker.track_frame_and_calibrate_scale
    jstep = jtracker.track_frame if known else jtracker.track_frame_and_calibrate_scale
    outs, state = _loop(tracker, *setup["seq"], step)
    jouts, jstate = _jloop(jtracker, *setup["jseq"], jstep)
    v = _check_against(
        outs, _stack(jouts, "joint_angles"), _stack(jouts, "wrist_xfs"), _stack(jouts, "valid"),
        ANGLE_TOL, WRIST_TOL_MM,
    )
    np.testing.assert_array_equal(_stack(outs, "n_views"), _stack(jouts, "n_views"))
    if not known:
        np.testing.assert_allclose(
            _stack(outs, "predicted_scales")[v], _stack(jouts, "predicted_scales")[v], atol=SCALE_TOL
        )
    np.testing.assert_array_equal(state.valid_history.numpy(), np.asarray(jstate.valid_history))
    np.testing.assert_allclose(
        state.temporal.mem_features.numpy(),
        np.moveaxis(np.asarray(jstate.temporal.mem_features), -1, 1), atol=1e-3,
    )


def test_predict_scales_and_calibrate_sequence_match_jax(setup):
    tracker, jtracker = setup["tracker"], setup["jtracker"]
    rig, seq, hand = setup["seq"]
    scales, valid, state = tracker.predict_scales(rig, seq, hand)
    jscales, jvalid, jstate = jtracker.predict_scales(*setup["jseq"])
    v = np.asarray(jvalid)
    np.testing.assert_array_equal(valid.numpy(), v)
    np.testing.assert_allclose(scales.numpy()[v], np.asarray(jscales)[v], atol=SCALE_TOL)
    np.testing.assert_array_equal(state.valid_history.numpy(), np.asarray(jstate.valid_history))
    for n in (3, 0):  # fewer than there are, all
        ours = float(tracker.calibrate_sequence(rig, seq, hand, n_calibration_samples=n))
        ref = float(jtracker.calibrate_sequence(*setup["jseq"], n_calibration_samples=n))
        np.testing.assert_allclose(ours, ref, atol=SCALE_TOL, err_msg=f"n={n}")
    # the first-N-valid mean, restated as the loop that appends frame by
    # frame, hand 0 before hand 1
    samples = [float(scales[t, h]) for t in range(T_FRAMES) for h in range(2) if valid[t, h]]
    assert len(samples) > 3
    np.testing.assert_allclose(
        float(tracker.calibrate_sequence(rig, seq, hand, n_calibration_samples=3)),
        np.mean(samples[:3]), rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(tracker.calibrate_sequence(rig, seq, hand, n_calibration_samples=0)),
        np.mean(samples), rtol=1e-6,
    )


def test_calibrate_sequences_batched_matches_jax_and_single(setup):
    """S=2: the sequence and a copy whose hand 0 drops out early, so the two
    rows take different first-N samples."""
    tracker, jtracker = setup["tracker"], setup["jtracker"]
    rig, seq, hand = setup["seq"]
    jrig, jseq, jhand = setup["jseq"]
    conf2 = seq.gt_confidences.clone()
    conf2[:2, 0] = 0.0
    seq2 = seq.map(lambda a: a)
    seq2.gt_confidences = conf2
    jseq2 = jseq.replace(gt_confidences=jnp.asarray(conf2.numpy()))

    rigs = rig.map(lambda a: torch.stack([a, a]))
    seqs = type(seq)(**{k: torch.stack([getattr(seq, k), getattr(seq2, k)])
                        for k in seq.__dataclass_fields__})
    hands = stack_hand_models([hand, hand])
    n = 4
    ours = port_tracker.calibrate_sequences_batched(
        tracker.model, tracker.config, rigs, seqs, tracker.init_state(4), hands,
        n_calibration_samples=n, device="cpu",
    )
    assert ours.shape == (2,)

    stack2 = lambda a, b: jax.tree_util.tree_map(lambda x, y: jnp.stack([x, y]), a, b)
    jinit = JTrackState(
        temporal=JTemporalState.zeros(4, jtracker.model.config),
        valid_history=jnp.zeros((4,), bool),
    )
    ref = jcalibrate_batched(
        jtracker.model, jtracker.config, jtracker.variables, stack2(jrig, jrig),
        stack2(jseq, jseq2), jinit, stack2(jhand, jhand), n_calibration_samples=n,
    )
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=SCALE_TOL)
    for i, s in enumerate((seq, seq2)):
        single = float(tracker.calibrate_sequence(rig, s, hand, n_calibration_samples=n))
        np.testing.assert_allclose(float(ours[i]), single, atol=1e-5)
    assert abs(float(ours[0]) - float(ours[1])) > 1e-7


@pytest.mark.parametrize("n, want", [(2, 2.5), (3, 3.0 + 1.0 / 3.0), (0, 4.5), (9, 4.5)])
def test_first_n_valid_mean_takes_samples_in_append_order(n, want):
    scales = torch.tensor([[9.0, 2.0, 3.0, 9.0, 5.0, 8.0]])
    valid = torch.tensor([[False, True, True, False, True, True]])
    got = port_tracker._first_n_valid_mean(scales, valid, n)
    np.testing.assert_allclose(got.numpy(), [want], rtol=1e-6)
    none = port_tracker._first_n_valid_mean(scales, torch.zeros_like(valid), n)
    assert float(none) == 0.0
