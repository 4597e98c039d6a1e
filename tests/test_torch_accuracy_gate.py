"""Accuracy gate of the port: the committed trained checkpoint, loaded by
the port's own loader, must track the held-out rendered sequence of
``tests/test_accuracy_gate.py`` (seed 901, ``hand_scale`` 1.07, the stroke
style the checkpoint was trained on, 32 frames, full width) to the same
32 mm, and land within 0.5 mm of what the JAX package measures on the same
frames."""
import os

import numpy as np
import pytest
import torch
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "synthetic.msgpack")
GATE_MM = 32.0
GATE_SEED = 901
RENDER_STYLE = "strokes"
PARITY_MM = 0.5


def _mpjpe(tracked_lm, gt_lm, valid):
    err = np.linalg.norm(tracked_lm - gt_lm, axis=-1).mean(axis=-1)  # [T, 2]
    return float(err[valid].mean())


@pytest.fixture(scope="module")
def gate_sequence():
    from umetrack_torch.utils import synthetic

    return synthetic.make_labels_dict(
        32, rng_seed=GATE_SEED, hand_scale=1.07, render_style=RENDER_STYLE, device="cpu"
    )


@pytest.fixture(scope="module")
def port_mpjpe(gate_sequence):
    from umetrack_torch.apps.common import load_model_cli
    from umetrack_torch.tracker import HandTracker, sequence_landmarks
    from umetrack_torch.utils.synthetic import our_sequence

    labels, images = gate_sequence
    rig, seq, hand = our_sequence(labels, images, "cpu")
    tracker = HandTracker(load_model_cli(CKPT, device="cpu"), device="cpu")
    results, _ = tracker.track_sequence(rig, seq, hand)
    tracked = sequence_landmarks(hand, results.joint_angles, results.wrist_xfs).numpy()
    gt = sequence_landmarks(hand, seq.gt_joint_angles, seq.gt_wrist_xfs).numpy()
    valid = results.valid.numpy()
    assert valid.any() and torch.isfinite(results.joint_angles).all()
    return _mpjpe(tracked, gt, valid)


def test_known_skeleton_mpjpe_gate(port_mpjpe):
    assert port_mpjpe <= GATE_MM, f"MPJPE {port_mpjpe:.2f} mm exceeds gate {GATE_MM} mm"


def test_mpjpe_within_parity_of_the_jax_package(port_mpjpe, gate_sequence):
    """The port's frames (its own noise upsampling under the same strokes)
    through the JAX tracker with the same checkpoint."""
    import jax

    from umetrack_tpu.models import init_model
    from umetrack_tpu.tracker import HandTracker, sequence_landmarks
    from umetrack_tpu.utils import synthetic
    from umetrack_tpu.utils.checkpoints import load_checkpoint

    labels, images = gate_sequence
    model, variables = init_model(jax.random.PRNGKey(0))
    rig, seq, hand = synthetic.our_sequence(labels, images)
    results, _ = HandTracker(model, load_checkpoint(CKPT, variables)).track_sequence(rig, seq, hand)
    tracked = np.asarray(sequence_landmarks(hand, results.joint_angles, results.wrist_xfs))
    gt = np.asarray(sequence_landmarks(hand, seq.gt_joint_angles, seq.gt_wrist_xfs))
    ref = _mpjpe(tracked, gt, np.asarray(results.valid))
    assert abs(port_mpjpe - ref) <= PARITY_MM, f"port {port_mpjpe:.3f} mm, JAX package {ref:.3f} mm"
