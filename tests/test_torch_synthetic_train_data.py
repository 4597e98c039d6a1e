"""The port's synthetic training data against the JAX package's: the
rendered ``make_torchdata_sample`` (its random numbers drawn in the JAX
package's order), the train app's ``synthetic_batches``, the corpus
writer's defaults; and the atomic ``save_checkpoint``."""
import inspect
import os

import numpy as np
import pytest
import torch
from flax import serialization

from umetrack_tpu.apps import train as japp
from umetrack_tpu.utils import synthetic as JS
from umetrack_torch.apps import train as app
from umetrack_torch.models import ModelConfig, make_model
from umetrack_torch.models.convert import to_flax_variables
from umetrack_torch.utils import checkpoints
from umetrack_torch.utils import synthetic as S
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

ENCLOSING_TOL_MM = 1e-3
# Frames: the same draws shaded by two tracers over nearly the same noise
# (tests/test_torch_render.py's bounds): pixels may differ by one grey level
# where a shaded value rounds the other way, and a handful at capsule
# boundaries, where a ray's nearest capsule flips, by more.
OFF_SHARE, N_FAR = 5e-4, 4


@pytest.mark.parametrize("hand_idx", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rendered_sample_equals_jax(seed, hand_idx):
    mono, labels = S.make_torchdata_sample(rng_seed=seed, t=3, hand_idx=hand_idx, render=True,
                                           device="cpu")
    jmono, jlabels = JS.make_torchdata_sample(rng_seed=seed, t=3, hand_idx=hand_idx)
    assert list(labels) == list(jlabels)
    for key in ("intrinsics", "extrinsics", "solved_joint_angles", "joint_angles", "wrist",
                "solved_wrist_xfs", "hand", "pinch"):
        np.testing.assert_array_equal(np.asarray(labels[key]), np.asarray(jlabels[key]), err_msg=key)
    focal = np.asarray(labels["intrinsics"])[0, 0, 0, 0]
    assert 170.0 <= focal <= 235.0  # the JAX package's per-sequence focal
    np.testing.assert_allclose(np.asarray(labels["enclosing_points"]),
                               np.asarray(jlabels["enclosing_points"]), atol=ENCLOSING_TOL_MM)
    assert mono.shape == jmono.shape == (3, 2, 120, 160) and mono.dtype == np.uint8
    diff = np.abs(mono.astype(np.int16) - jmono.astype(np.int16))
    assert (diff > 0).sum() <= OFF_SHARE * diff.size, f"{(diff > 0).sum()} pixels differ"
    assert (diff > 1).sum() <= N_FAR, f"{(diff > 1).sum()} pixels differ by more than one grey level"


@pytest.mark.parametrize("window", [1, 3])
def test_synthetic_batches_equal_jax(window):
    """The first batch of 3 sequences: labels and crop geometry equal, the
    crops resampled from frames that agree as above."""
    ours = next(app.synthetic_batches(3, (96, 96), window=window, device="cpu"))
    ref = next(japp.synthetic_batches(3, (96, 96), window=window))
    frame, jframe = (ours.frame, ref.frame) if window == 1 else (ours.frames, ref.frames)
    for key in ("gt_joint_angles", "gt_wrist_world", "gt_scales"):
        np.testing.assert_array_equal(getattr(ours, key).numpy(), np.asarray(getattr(ref, key)), err_msg=key)
    np.testing.assert_array_equal(ours.skeleton.joint_rest_positions.numpy(),
                                  np.asarray(ref.skeleton.joint_rest_positions))
    for key in ("n_views", "hand_idx", "use_memory"):
        np.testing.assert_array_equal(getattr(frame, key).numpy(), np.asarray(getattr(jframe, key)))
    np.testing.assert_allclose(frame.intrinsics.numpy(), np.asarray(jframe.intrinsics), rtol=1e-5)
    np.testing.assert_allclose(frame.extrinsics.numpy(), np.asarray(jframe.extrinsics), atol=1e-6)
    diff = np.abs(frame.images.numpy() - np.asarray(jframe.images))
    assert diff.mean() < 1e-4 and (diff > 1.01 / 255).mean() < 1e-3, (diff.mean(), diff.max())


def test_synthetic_batches_split_the_global_batch_over_ranks():
    """Rank r of 2 builds rows 2r, 2r+1 of each global batch of 4."""
    whole = app.synthetic_batches(4, (96, 96), device="cpu")
    halves = [app.synthetic_batches(4, (96, 96), device="cpu", distrib_info=(r, 2)) for r in range(2)]
    for _ in range(2):
        full = next(whole)
        parts = [next(h) for h in halves]
        for r, part in enumerate(parts):
            assert torch.equal(part.gt_joint_angles, full.gt_joint_angles[2 * r:2 * r + 2])
            assert torch.equal(part.frame.images, full.frame.images[2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="do not split"):
        next(app.synthetic_batches(3, (96, 96), device="cpu", distrib_info=(0, 2)))


def test_corpus_writer_defaults_are_the_jax_packages():
    ours = inspect.signature(S.write_torchdata_corpus).parameters
    ref = inspect.signature(JS.write_torchdata_corpus).parameters
    for name in ("n_train", "n_test", "t", "h", "w", "seed0"):
        assert ours[name].default == ref[name].default, name
    assert ours["render"].default is True
    assert inspect.signature(S.make_torchdata_sample).parameters["render"].default is False


def test_save_checkpoint_is_atomic_and_writes_flax_bytes(tmp_path, monkeypatch):
    sd = make_model(ModelConfig(start_planes=8, backbone_blocks=(1, 1, 1, 1)), seed=1).state_dict()
    path = str(tmp_path / "ckpt.msgpack")
    assert checkpoints.save_checkpoint(path, sd) == path
    with open(path, "rb") as fp:
        first = fp.read()
    assert first == serialization.to_bytes(to_flax_variables(sd))
    assert os.listdir(tmp_path) == ["ckpt.msgpack"]

    # a write that dies before the file is in place leaves the old one whole
    # and no partial file behind
    def dies(src, dst):
        raise OSError("killed mid-write")

    monkeypatch.setattr(checkpoints.os, "replace", dies)
    other = {k: v + 1 if v.is_floating_point() else v for k, v in sd.items()}
    with pytest.raises(OSError, match="killed"):
        checkpoints.save_checkpoint(path, other)
    assert os.listdir(tmp_path) == ["ckpt.msgpack"]
    with open(path, "rb") as fp:
        assert fp.read() == first
