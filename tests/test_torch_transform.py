"""Port parity for the torch_data preprocess: ``preprocess_sequence`` of
``umetrack_torch`` against the JAX one on the same synthetic sample (bounds
of tests/test_transform.py:31-71), single and batched, and
``mirrored_hand_model`` against the JAX one."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umetrack_tpu.data import transform as jtransform
from umetrack_tpu.kinematics import hand as jhand
from umetrack_torch.data import bundles, transform
from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict, mirrored_hand_model
from umetrack_torch.utils.synthetic import make_torchdata_sample


def _jax_preprocess(mono, labels):
    return jax.jit(lambda d: jtransform.preprocess_sequence(d, (96, 96)))(
        jtransform.parse_raw_buffers(mono, labels))


def _check(ours_input, ours_target, ref_input, ref_target):
    def close(a, b, **tol):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)

    close(ours_input.intrinsics, ref_input.intrinsics, rtol=1e-4, atol=1e-4)
    close(ours_input.extrinsics_xf, ref_input.extrinsics_xf, rtol=1e-3, atol=1e-4)
    # exact bilinear both sides; the sample coordinates round differently
    close(ours_input.left_images, ref_input.left_images, atol=2e-3)
    close(ours_input.hand_idx, ref_input.hand_idx, atol=0)
    for ours_pose, ref_pose in (
        (ours_input.orig_pose_data, ref_input.orig_pose_data),
        (ours_input.s_solved_pose_data, ref_input.s_solved_pose_data),
    ):
        close(ours_pose.wrist_xfs, ref_pose.wrist_xfs, rtol=1e-5, atol=1e-6)
        close(ours_pose.joint_angles, ref_pose.joint_angles, rtol=1e-5, atol=1e-7)
        for field in ("joint_rest_positions", "joint_rotation_axes", "landmark_rest_positions"):
            close(getattr(ours_pose.left_hand_model, field),
                  getattr(ref_pose.left_hand_model, field), rtol=1e-5, atol=1e-7)
    close(ours_target.gt_wrist_xfs, ref_target.gt_wrist_xfs, rtol=1e-5, atol=1e-6)
    close(ours_target.solved_wrist_xfs, ref_target.solved_wrist_xfs, rtol=1e-5, atol=1e-6)
    close(ours_target.gt_scale, ref_target.gt_scale, rtol=1e-6)
    close(ours_target.pinch, ref_target.pinch, atol=0)


@pytest.mark.parametrize("hand_idx", [0, 1])
def test_preprocess_sequence_matches_jax(hand_idx):
    mono, labels = make_torchdata_sample(rng_seed=3, hand_idx=hand_idx, hand_scale=1.1)
    ours_input, ours_target = transform.preprocess({"mono": mono, "labels": labels}, device="cpu")
    assert ours_input.left_images.shape == (3, 2, 96, 96)
    assert 0.5 < float((ours_input.left_images > 0).float().mean())  # the crops see the frames
    _check(ours_input, ours_target, *_jax_preprocess(mono, labels))


def test_preprocess_batch_of_sequences_matches_jax_per_sequence():
    """The leading sequence dim stands in for the JAX package's vmap: a
    batch of both hands equals the JAX preprocess of each sequence."""
    samples = [make_torchdata_sample(rng_seed=20 + i, hand_idx=i % 2) for i in range(3)]
    raw = bundles.to_device(
        bundles.collate([transform.parse_raw_buffers(m, l) for m, l in samples]), "cpu")
    ours_input, ours_target = transform.preprocess_sequence(raw, (96, 96))
    assert ours_input.left_images.shape == (3, 3, 2, 96, 96)
    for i, (mono, labels) in enumerate(samples):
        _check(ours_input.map(lambda a: a[i]), ours_target.map(lambda a: a[i]),
               *_jax_preprocess(mono, labels))


def test_preprocess_leaves_uint8_frames_uncast(monkeypatch):
    seen = []
    real = transform.resample_images

    def spy(images, *args, **kwargs):
        seen.append(images.dtype)
        return real(images, *args, **kwargs)

    monkeypatch.setattr(transform, "resample_images", spy)
    mono, labels = make_torchdata_sample(rng_seed=1, t=2)
    transform.preprocess({"mono": mono, "labels": labels}, device="cpu")
    assert seen == [torch.uint8]


def test_mirrored_hand_model_matches_jax_exactly():
    d = load_generic_hand_dict()
    hand, jh = from_dict(d), jhand.from_dict(d)
    for mask in (True, False):
        ours, ref = mirrored_hand_model(hand, mask), jhand.mirrored_hand_model(jh, mask)
        for f in ("joint_rotation_axes", "joint_rest_positions", "landmark_rest_positions",
                  "landmark_rest_bone_weights"):
            np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)))
    stacked = hand.map(lambda a: torch.stack([a, a, a]))
    jstacked = jax.tree_util.tree_map(lambda a: jnp.stack([a, a, a]), jh)
    mask = np.array([True, False, True])
    ours = mirrored_hand_model(stacked, torch.from_numpy(mask))
    ref = jhand.mirrored_hand_model(jstacked, jnp.asarray(mask))
    np.testing.assert_array_equal(ours.joint_rotation_axes.numpy(), np.asarray(ref.joint_rotation_axes))
    np.testing.assert_array_equal(ours.joint_rest_positions.numpy(), np.asarray(ref.joint_rest_positions))
    assert not torch.equal(ours.joint_rest_positions[0], ours.joint_rest_positions[1])
