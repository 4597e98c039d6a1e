"""Port parity for the slice as a whole: ``track_sequence`` and
``track_sequences_batched`` of ``umetrack_torch`` (plain sampler, CPU)
against the JAX tracker with the pool kernel in interpret mode and with the
gather sampler, same weights, same synthetic sequence, small config."""
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
from umetrack_tpu.tracker.tracker import track_sequences_batched as jbatched
from umetrack_tpu.tracker.types import TrackState as JTrackState
from umetrack_torch.kinematics.hand import stack_hand_models
from umetrack_torch.models import ModelConfig, UmeTrackNet, from_flax_variables
from umetrack_torch.ops.resample import bilinear_sample_pool_plain
from umetrack_torch.tracker import HandTracker, TrackerConfig, sequence_landmarks
from umetrack_torch.tracker import tracker as port_tracker
from umetrack_torch.tracker.types import CameraRig, FrameObservation
from umetrack_torch.utils.synthetic import our_sequence
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
T_FRAMES = 4


def _check(ours, ref):
    """The tolerances of tests/test_tracker.py:354-360: valid masks equal,
    angles within 1e-3 rad, wrist translation within 0.1 mm."""
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(ours.valid.numpy(), v)
    assert v.any() and not v.all()  # the confidence dropout is in the window
    np.testing.assert_allclose(
        ours.joint_angles.numpy()[v], np.asarray(ref.joint_angles)[v], atol=1e-3
    )
    np.testing.assert_allclose(
        ours.wrist_xfs.numpy()[v][..., :3, 3], np.asarray(ref.wrist_xfs)[v][..., :3, 3], atol=0.1
    )


@pytest.fixture(scope="module")
def setup():
    jcfg = JModelConfig(**SMALL)
    jvars = jax.jit(lambda key: init_model(key, jcfg)[1])(jax.random.PRNGKey(5))
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars)
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.random(a.shape) * 0.2).astype(np.float32), variables["batch_stats"]
    )
    cfg = ModelConfig(**SMALL)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    labels, images = synthetic.make_labels_dict(T_FRAMES, rng_seed=13, render=False)
    return dict(
        jmodel=make_model(jcfg),
        jvars=jax.tree_util.tree_map(jnp.asarray, variables),
        jseq=synthetic.our_sequence(labels, images),
        tracker=HandTracker(model, device="cpu"),
        seq=our_sequence(labels, images, "cpu"),
    )


@pytest.fixture(scope="module")
def port_single(setup):
    rig, seq, hand = setup["seq"]
    return setup["tracker"].track_sequence(rig, seq, hand)


@pytest.mark.parametrize("sampler", ["pallas_pool", "gather1d"])
def test_track_sequence_matches_jax(setup, port_single, sampler):
    ours, state = port_single
    ref, ref_state = JHandTracker(
        setup["jmodel"], setup["jvars"], JTrackerConfig(sampler=sampler)
    ).track_sequence(*setup["jseq"])
    _check(ours, ref)
    np.testing.assert_array_equal(state.valid_history.numpy(), np.asarray(ref_state.valid_history))
    np.testing.assert_allclose(
        state.temporal.mem_features.numpy(),
        np.moveaxis(np.asarray(ref_state.temporal.mem_features), -1, 1), atol=1e-3,
    )
    lm = sequence_landmarks(setup["seq"][2], ours.joint_angles, ours.wrist_xfs)
    assert lm.shape == (T_FRAMES, 2, 21, 3) and torch.isfinite(lm).all()


def test_track_sequences_batched_matches_jax(setup, port_single):
    """S=2 copies of the sequence through the batched path: results
    [T, S, 2, ...] match the JAX batched tracker (pool kernel, interpret
    mode) and, per sequence, the port's own single-sequence run."""
    jrig, jseq, jhand = setup["jseq"]
    stack2 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), tree)
    jinit = JTrackState(
        temporal=JTemporalState.zeros(4, setup["jmodel"].config),
        valid_history=jnp.zeros((4,), bool),
    )
    ref, _ = jbatched(
        setup["jmodel"], JTrackerConfig(sampler="pallas_pool"), setup["jvars"],
        stack2(jrig), stack2(jseq), jinit, stack2(jhand),
    )
    rig, seq, hand = setup["seq"]
    rigs = rig.map(lambda a: torch.stack([a, a]))
    seqs = seq.map(lambda a: torch.stack([a, a]))
    ours, _ = setup["tracker"].track_sequences_batched(rigs, seqs, stack_hand_models([hand, hand]))
    assert ours.joint_angles.shape == (T_FRAMES, 2, 2, 22)
    _check(ours, ref)
    single, _ = port_single
    for s in range(2):
        np.testing.assert_array_equal(ours.valid[:, s].numpy(), single.valid.numpy())
        np.testing.assert_allclose(
            ours.joint_angles[:, s].numpy(), single.joint_angles.numpy(), atol=1e-5
        )


def test_per_slot_image_warp_matches_pool_path(setup, port_single):
    """``sampler="plain_image"`` warps every slot from its own copy of its
    source view through the single-image sampler (``_warp_crops``): the
    same crops as the pool path, so the same track."""
    rig, seq, hand = setup["seq"]
    tracker = HandTracker(setup["tracker"].model, TrackerConfig(sampler="plain_image"), device="cpu")
    calls = []
    real = port_tracker._warp_crops
    port_tracker._warp_crops = lambda *a: calls.append(a[3]) or real(*a)
    try:
        ours, state = tracker.track_sequence(rig, seq, hand)
    finally:
        port_tracker._warp_crops = real
    assert calls == ["plain"]  # one sampler call for all slots of all frames
    pool, pool_state = port_single
    v = pool.valid.numpy()
    np.testing.assert_array_equal(ours.valid.numpy(), v)
    np.testing.assert_allclose(ours.joint_angles.numpy()[v], pool.joint_angles.numpy()[v], atol=1e-5)
    np.testing.assert_allclose(
        ours.wrist_xfs.numpy()[v][..., :3, 3], pool.wrist_xfs.numpy()[v][..., :3, 3], atol=0.01
    )
    np.testing.assert_allclose(
        state.temporal.mem_features.numpy(), pool_state.temporal.mem_features.numpy(), atol=1e-5
    )


def test_entry_points_need_cuda_unless_cpu_is_asked(setup, monkeypatch):
    """With no GPU, the default device raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rig, seq, hand = setup["seq"]
    tracker = setup["tracker"]
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tracker.track_sequence(
            tracker.model, tracker.config, rig, seq, tracker.init_state(), hand
        )
    with pytest.raises(RuntimeError, match="CUDA"):
        HandTracker(tracker.model)
    with pytest.raises(ValueError, match="kernel"):
        port_tracker.track_sequence(
            tracker.model, TrackerConfig(sampler="kernel"), rig, seq,
            tracker.init_state(), hand, device="cpu",
        )
    with pytest.raises(ValueError, match="unknown sampler"):
        TrackerConfig(sampler="pallas_win").resolved_sampler(torch.device("cpu"))
    assert isinstance(rig, CameraRig) and isinstance(seq, FrameObservation)


@pytest.mark.parametrize("sampler", ["kernel", "kernel_win", "kernel_full"])
def test_kernel_sampler_on_the_cpu_raises(setup, sampler):
    """A kernel sampler needs CUDA tensors: the batched entry refuses it on
    the CPU instead of falling back to a plain version."""
    rig, seq, hand = setup["seq"]
    model = setup["tracker"].model
    rigs, seqs = rig.map(lambda a: a[None]), seq.map(lambda a: a[None])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        port_tracker.track_sequences_batched(
            model, TrackerConfig(sampler=sampler), rigs, seqs, setup["tracker"].init_state(),
            stack_hand_models([hand]), device="cpu",
        )


def test_pool_warp_operands_give_the_batched_crops(setup):
    """``pool_warp_operands`` (what the pool kernel is checked and timed on)
    sampled by the plain pool sampler are the crops that the batched entry
    hands the model, before its ``/255`` and view mask."""
    rig, seq, hand = setup["seq"]
    rigs = rig.map(lambda a: torch.stack([a, a]))
    seqs = seq.map(lambda a: torch.stack([a, a.flip(0)]))
    hands = stack_hand_models([hand, hand])
    config = TrackerConfig()
    pool, coords, src_idx = port_tracker.pool_warp_operands(config, rigs, seqs, hands)
    assert pool.shape == (2 * T_FRAMES * 4, 480, 640) and src_idx.dtype == torch.int32
    warped = bilinear_sample_pool_plain(pool, coords, src_idx)
    crop_sets, crops = port_tracker._prepare_sequences_merged(config, rigs, seqs, hands, 1, "plain")
    t, rows, v = crops.shape[:3]
    want = warped.reshape(2, t, 2, v, *crops.shape[-2:]).transpose(0, 1).reshape(crops.shape) / 255.0
    want = torch.where(crop_sets.view_valid[..., None, None], want, torch.zeros_like(want))
    assert (t, rows) == (T_FRAMES, 4) and crop_sets.view_valid.any()
    torch.testing.assert_close(crops, want, rtol=0, atol=0)
