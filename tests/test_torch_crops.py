"""Port parity: skinning and crop-set generation of ``umetrack_torch``
against ``umetrack_tpu`` on a synthetic sequence, and both packages' source
coordinates against a float64 run of the port's crop geometry."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import synthetic
from umetrack_tpu.kinematics.skinning import skin_landmarks as jskin
from umetrack_tpu.tracker import TrackerConfig as JTrackerConfig
from umetrack_tpu.tracker import gen_crop_set as jgen_crop_set
from umetrack_tpu.tracker.crops import static_crop_points_local as jstatic
from umetrack_tpu.tracker.tracker import _crop_coords as jcrop_coords
from umetrack_torch.kinematics.skinning import skin_landmarks
from umetrack_torch.tracker import TrackerConfig, gen_crop_set
from umetrack_torch.tracker.crops import static_crop_points_local
from umetrack_torch.tracker.tracker import _frame_geometry
from umetrack_torch.utils.synthetic import our_sequence

T_FRAMES = 4


@pytest.fixture(scope="module")
def sequences():
    labels, images = synthetic.make_labels_dict(T_FRAMES, rng_seed=7, render=False)
    return synthetic.our_sequence(labels, images), our_sequence(labels, images, "cpu")


def test_skinning_matches_jax(sequences):
    (_, jseq, jhand), (_, seq, hand) = sequences
    ours = skin_landmarks(hand, seq.gt_joint_angles, seq.gt_wrist_xfs)
    ref = jax.jit(jskin)(jhand, jseq.gt_joint_angles, jseq.gt_wrist_xfs)
    assert ours.shape == (T_FRAMES, 2, 21, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-3, rtol=1e-5)  # mm
    np.testing.assert_allclose(
        static_crop_points_local(hand, 63).numpy(), np.asarray(jstatic(jhand, 63)),
        atol=1e-3, rtol=1e-5,
    )


@pytest.mark.parametrize("min_num_crops", [1, 2])
def test_crop_set_matches_jax(sequences, min_num_crops):
    """All frames at once against the JAX per-frame vmap, at the crop
    tolerances of tests/test_tracker.py:98-105; masks and indices equal."""
    (jrig, jseq, jhand), (rig, seq, hand) = sequences
    ours = gen_crop_set(
        rig, seq.T_world_from_camera, hand, seq.gt_joint_angles, seq.gt_wrist_xfs,
        seq.gt_confidences, TrackerConfig(), min_num_crops,
    )
    ref = jax.jit(jax.vmap(
        lambda t, a, w, c: jgen_crop_set(
            jrig, t, jhand, a, w, c, JTrackerConfig(), min_num_crops,
            jstatic(jhand, 63),
        )
    ))(jseq.T_world_from_camera, jseq.gt_joint_angles, jseq.gt_wrist_xfs,
       jseq.gt_confidences)
    for name in ("src_cam_idx", "view_valid", "hand_valid", "n_views"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)), name)
    vv = np.asarray(ref.view_valid)
    assert vv.any()
    np.testing.assert_allclose(
        ours.intrinsics.numpy()[vv], np.asarray(ref.intrinsics)[vv], rtol=1e-4, atol=1e-3
    )
    np.testing.assert_allclose(
        ours.T_world_from_eye.numpy()[vv], np.asarray(ref.T_world_from_eye)[vv],
        rtol=1e-3, atol=5e-2,
    )


def test_source_coordinates_are_within_f32_rounding_of_a_float64_run(sequences):
    """The port's crop geometry runs in whatever float type it is given.  In
    float64 it is the witness: each package's f32 source coordinates lie
    within 0.03 pixels of it (measured: 0.016 at most and 0.003 on average
    for the port, 0.014 and 0.003 for the JAX package), which is all that two differently batched f32 calls can differ
    by, and what trained weights turn into 1e-3 rad."""
    (jrig, jseq, jhand), (rig, seq, hand) = sequences
    config = TrackerConfig()
    crops32, coords32 = _frame_geometry(config, rig, seq, hand, 1)
    to64 = lambda tree: tree.map(lambda a: a.double() if a.is_floating_point() else a)
    crops64, coords64 = _frame_geometry(config, to64(rig), to64(seq), to64(hand), 1)
    assert coords64.dtype == torch.float64 and crops64.T_world_from_eye.dtype == torch.float64
    vv = crops64.view_valid
    assert vv.any() and torch.equal(crops32.view_valid, vv)
    assert torch.equal(crops32.src_cam_idx[vv], crops64.src_cam_idx[vv])

    def per_frame(t_wfc, angles, wrists, conf):
        crop_set = jgen_crop_set(
            jrig, t_wfc, jhand, angles, wrists, conf, JTrackerConfig(), 1, jstatic(jhand, 63))
        return jcrop_coords(jrig, t_wfc, crop_set, JTrackerConfig().crop_size)

    jcoords = np.array(jax.jit(jax.vmap(per_frame))(
        jseq.T_world_from_camera, jseq.gt_joint_angles, jseq.gt_wrist_xfs, jseq.gt_confidences))
    assert jcoords.dtype == np.float32
    jcoords = torch.from_numpy(jcoords).reshape(coords64.shape)
    for name, coords in (("port", coords32), ("JAX package", jcoords)):
        gap = (coords.double() - coords64).abs()[vv]
        print(f"{name}: f32 against float64 coordinates, max {float(gap.max()):.4f}, mean {float(gap.mean()):.4f} pixels")
        assert float(gap.max()) <= 0.03 and float(gap.mean()) <= 0.01, (name, float(gap.max()))
        assert float(gap.max()) > 0  # f32 does round
