"""Port parity: every function of ``umetrack_torch.metrics`` against
``umetrack_tpu.metrics`` on the same seeded numpy inputs (rtol 1e-9: both
are float64 numpy on the host), and ``utils/profiling.py::PhaseTimers``."""
import time

import numpy as np
import pytest

from umetrack_tpu import metrics as jmetrics
from umetrack_torch import metrics
from umetrack_torch.utils.profiling import PhaseTimers

RTOL = 1e-9


def _errors(seed, shape):
    return np.random.default_rng(seed).gamma(2.0, 8.0, size=shape)


def test_constants_and_caveat_are_equal():
    assert metrics.MPJPA_CAVEAT == jmetrics.MPJPA_CAVEAT
    assert metrics.MAX_LANDMARK_ERROR_MM == jmetrics.MAX_LANDMARK_ERROR_MM
    np.testing.assert_array_equal(metrics.PCK_THRESHOLDS, jmetrics.PCK_THRESHOLDS)


@pytest.mark.parametrize("axis, masked", [(None, False), (None, True), (0, False), (1, True)])
def test_pck_curve_matches(axis, masked):
    errors = _errors(0, (5, 40))
    mask = (np.random.default_rng(1).random((5, 40)) > 0.3).astype(np.float64) if masked else None
    if masked:
        mask[2] = 0.0  # a row with nothing in it: the safe division's default
    ours = metrics.PCK_curve(errors, metrics.PCK_THRESHOLDS, mask=mask, axis=axis)
    ref = jmetrics.PCK_curve(errors, jmetrics.PCK_THRESHOLDS, mask=mask, axis=axis)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    assert ours.min() >= 0.0 and ours.max() <= 1.0


def test_normalized_auc_matches():
    curves = np.sort(np.random.default_rng(2).random((3, 4, 101)), axis=-1)
    ours = metrics.normalized_AUC(metrics.PCK_THRESHOLDS, curves)
    np.testing.assert_allclose(ours, jmetrics.normalized_AUC(jmetrics.PCK_THRESHOLDS, curves), rtol=RTOL)
    np.testing.assert_allclose(
        metrics.normalized_AUC(metrics.PCK_THRESHOLDS, curves[0, 0] * 100.0, y_max=100.0),
        jmetrics.normalized_AUC(jmetrics.PCK_THRESHOLDS, curves[0, 0] * 100.0, y_max=100.0), rtol=RTOL,
    )
    np.testing.assert_allclose(metrics.normalized_AUC(np.linspace(0, 1, 11), np.ones(11)), 1.0)


def _sequence(seed, t=12):
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 60, (2, t, 21, 3))
    tracked = gt + rng.normal(0, 6, gt.shape)
    valid = rng.random((2, t)) > 0.25
    angles = rng.uniform(-1, 1, (2, t, 22))
    return gt, tracked, valid, angles, angles + rng.normal(0, 0.1, angles.shape)


@pytest.mark.parametrize("with_angles", [True, False])
def test_compute_sequence_metrics_matches(with_angles):
    gt, tracked, valid, ga, ta = _sequence(3)
    kw = dict(gt_joint_angles=ga, tracked_joint_angles=ta) if with_angles else {}
    ours = metrics.compute_sequence_metrics(gt, tracked, valid, **kw)
    ref = jmetrics.compute_sequence_metrics(gt, tracked, valid, **kw)
    for name in ("keypoint_errors", "keypoint_accelerations", "gt_keypoint_accelerations",
                 "angle_errors_deg"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=name)
    assert ours.keypoint_errors.shape == (int(valid.sum()),)
    assert ours.angle_errors_deg.size == (int(valid.sum()) if with_angles else 0)


@pytest.mark.parametrize("with_angles", [True, False])
def test_aggregate_matches(with_angles):
    ours_list, ref_list, valid_list = [], [], []
    for seed in (4, 5, 6):
        gt, tracked, valid, ga, ta = _sequence(seed, t=9 + seed)
        kw = dict(gt_joint_angles=ga, tracked_joint_angles=ta) if with_angles else {}
        ours_list.append(metrics.compute_sequence_metrics(gt, tracked, valid, **kw))
        ref_list.append(jmetrics.compute_sequence_metrics(gt, tracked, valid, **kw))
        valid_list.append(valid)
    ours = metrics.aggregate(ours_list, valid_list)
    ref = jmetrics.aggregate(ref_list, valid_list)
    assert list(ours) == list(ref)
    assert ("mpjpa_deg" in ours) == with_angles
    for k, v in ref.items():
        if isinstance(v, str):
            assert ours[k] == v
        else:
            np.testing.assert_allclose(ours[k], v, rtol=RTOL, err_msg=k)
    assert metrics.aggregate([], []) == jmetrics.aggregate([], []) == {}


def test_phase_timers_accumulate_and_report():
    timers = PhaseTimers()
    for _ in range(2):
        with timers.phase("track", items=8, barrier="cpu"):
            time.sleep(0.01)
    with timers.phase("stage"):
        pass
    with pytest.raises(KeyError):
        with timers.phase("track", items=1):
            raise KeyError("inside")  # the time of a failed block still counts
    assert timers.counts == {"track": 3, "stage": 1}
    assert timers.items["track"] == 17
    assert timers.as_dict()["track"] >= 0.02
    lines = timers.report().splitlines()
    assert lines[0].startswith("stage: ") and "items/s" not in lines[0]
    assert lines[1].startswith("track: ") and "over 3 calls" in lines[1] and "items/s" in lines[1]

