"""The port's three eval apps on the CPU, driven as ``tests/test_apps.py``
drives the JAX package's: ``run_eval_known_skeleton`` and
``run_eval_unknown_skeleton`` with ``--device cpu --synthetic`` and few
frames, then ``load_eval``; and the known-skeleton app's summary against the
JAX app's on the same generated sequence (seeded weights differ between the
packages, so both run the committed checkpoint)."""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from umetrack_tpu.apps import load_eval as jload_eval
from umetrack_torch.apps import (
    load_eval,
    run_eval_known_skeleton,
    run_eval_unknown_skeleton,
)
from umetrack_torch.apps.common import load_model_cli, tracker_config_from_args
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "synthetic.msgpack")
FRAMES = 4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both apps' ``main`` with the checkpoint into the original project's
    layout ``eval_results_{mode}/real/separate_hand``."""
    root = tmp_path_factory.mktemp("eval")
    common = ["--device", "cpu", "--synthetic", "1", "--synthetic-frames", str(FRAMES),
              "--checkpoint", CKPT]
    known_dir = root / "eval_results_known_skeleton" / "real" / "separate_hand"
    known = run_eval_known_skeleton.main(["--output-dir", str(known_dir)] + common)
    unknown_dir = root / "eval_results_unknown_skeleton" / "real" / "separate_hand"
    unknown = run_eval_unknown_skeleton.main(
        ["--output-dir", str(unknown_dir), "--n-calibration-samples", "5"] + common)
    return root, known_dir, unknown_dir, known, unknown


def _artifact(folder):
    arts = sorted(folder.rglob("*.npy"))
    assert len(arts) == 1
    with open(arts[0], "rb") as fp:
        return pickle.load(fp)


def test_known_skeleton_app_writes_artifacts(results):
    _, known_dir, _, errors, _ = results
    art = _artifact(known_dir)
    assert art["tracked_keypoints"].shape == (2, FRAMES, 21, 3)
    assert art["valid_tracking"].shape == (2, FRAMES)
    assert not art["valid_tracking"][1, FRAMES // 3]  # the dropout frames are invalid for hand 1
    assert art["valid_tracking"][0].all()
    assert len(errors) == 1 and np.isfinite(errors[0])


def test_unknown_skeleton_app_writes_a_calibrated_scale(results):
    _, _, unknown_dir, _, errors = results
    art = _artifact(unknown_dir)
    assert np.isfinite(art["calibrated_scale"]) and 0.5 < float(art["calibrated_scale"]) < 2.0
    assert art["tracked_keypoints"].shape == (2, FRAMES, 21, 3)
    assert len(errors) == 1 and np.isfinite(errors[0])


def test_load_eval_summaries_agree_with_the_jax_package(results, capsys):
    """``load_eval`` finds both protocols' folders; the JAX package's
    ``load_eval`` over the same artifacts gives the same summaries."""
    root = results[0]
    summary = load_eval.main(["--results-root", str(root)])
    printed = capsys.readouterr().out
    assert set(summary) == {"known_skeleton/separate_hand", "unknown_skeleton/separate_hand"}
    assert "MPJPA" in printed and "success rate" in printed
    ref = jload_eval.main(["--results-root", str(root)])
    capsys.readouterr()
    for key, summ in summary.items():
        assert np.isfinite(summ["mpjpe_mm"]) and "mpjpa_deg" in summ
        assert 0 < summ["success_rate"] <= 1.0
        assert list(summ) == list(ref[key])
        for k, v in ref[key].items():
            if isinstance(v, str):
                assert summ[k] == v
            else:
                np.testing.assert_allclose(summ[k], v, rtol=1e-9, err_msg=k)
    load_eval.main(["--results-root", str(root), "--json"])
    assert set(json.loads(capsys.readouterr().out)) == set(summary)
    # one artifact folder, and a folder with none
    one = load_eval.main(["--results-root", str(results[1])])
    assert list(one) == ["all"] and one["all"] == summary["known_skeleton/separate_hand"]
    assert load_eval.aggregate_metrics(str(root / "nothing_here")) == {}


def test_known_skeleton_app_matches_the_jax_app(results, tmp_path):
    """The same flags through the JAX package's app: the sequence's labels
    are the same, its frames are drawn by each package's own renderer (within
    a grey level of each other), and the checkpoint is the same file, so the
    two apps' mean errors agree within the 0.5 mm parity budget."""
    from umetrack_tpu.apps import run_eval_known_skeleton as japp

    japp.main(["--output-dir", str(tmp_path), "--synthetic", "1",
               "--synthetic-frames", str(FRAMES), "--checkpoint", CKPT, "--dtype", "float32"])
    ref = _artifact(tmp_path)
    ours = _artifact(results[1])
    np.testing.assert_array_equal(ours["valid_tracking"], ref["valid_tracking"])
    np.testing.assert_array_equal(ours["gt_joint_angles"], ref["gt_joint_angles"])
    np.testing.assert_allclose(ours["gt_keypoints"], ref["gt_keypoints"], atol=1e-3)
    from umetrack_torch.apps.sequence_eval import sequence_mean_error

    assert abs(sequence_mean_error(ours) - sequence_mean_error(ref)) < 0.5


def test_synthetic_scale_and_flags():
    assert run_eval_known_skeleton.synthetic_scale(3, 0.0) is None
    from umetrack_tpu.apps.run_eval_known_skeleton import synthetic_scale as jscale

    for i in (0, 7, 1_000_003):
        assert run_eval_known_skeleton.synthetic_scale(i, 0.15) == jscale(i, 0.15)
    with pytest.raises(SystemExit):
        run_eval_known_skeleton.main(["--output-dir", "x", "--device", "cpu"])  # no input
    with pytest.raises(SystemExit):
        run_eval_unknown_skeleton.main(["--output-dir", "x", "--sampler", "gather1d"])


def test_load_model_cli_and_tracker_config(tmp_path):
    import argparse

    model = load_model_cli(CKPT, "auto", "cpu")
    assert not model.training and next(model.parameters()).device.type == "cpu"
    assert model.config.compute_dtype == "float32"  # 'auto' is f32 on every device
    seeded = load_model_cli(None, "float32", "cpu")
    assert not all(
        (a == b).all() for a, b in zip(model.state_dict().values(), seeded.state_dict().values())
    )
    bf16 = load_model_cli(CKPT, "bfloat16", "cpu")
    assert bf16.config.compute_dtype == "bfloat16"
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), bf16.state_dict().values()))
    with pytest.raises(ValueError, match="float16"):
        load_model_cli(CKPT, "float16", "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model_cli(CKPT)  # no card here, and no silent CPU run
    cfg = tracker_config_from_args(argparse.Namespace(sampler="plain"), enable_memory=False)
    assert cfg.sampler == "plain" and not cfg.enable_memory
    assert tracker_config_from_args(argparse.Namespace(sampler=None)).sampler is None


def test_run_real_streams_mp4_sequences(tmp_path):
    """``run_real`` over a tiny raw_data tree written here (one mp4 strip +
    JSON under ``testing``): the artifact covers the video's frames, a second
    run skips it, ``--override`` redoes it."""
    import cv2

    from umetrack_torch.utils import synthetic

    t, h, w = 5, 480, 640
    labels, images = synthetic.make_labels_dict(t, rng_seed=4, render_style="strokes", device="cpu")
    folder = tmp_path / "raw" / "user" / "testing"
    folder.mkdir(parents=True)
    path = str(folder / "seq.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w * 4, h), False)
    assert vw.isOpened()
    for frame in images:
        vw.write(np.concatenate(list(frame), axis=1))
    vw.release()
    with open(path[:-4] + ".json", "w") as fp:
        json.dump(labels, fp)

    out = tmp_path / "out"
    args = ["--input-dir", str(tmp_path / "raw"), "--output-dir", str(out), "--device", "cpu",
            "--chunk", "4"]
    errors = run_eval_known_skeleton.main(args)
    assert len(errors) == 1 and np.isfinite(errors[0])
    art = _artifact(out)
    assert art["tracked_keypoints"].shape == (2, t, 21, 3)
    assert run_eval_known_skeleton.main(args) == []
    assert len(run_eval_known_skeleton.main(args + ["--override"])) == 1
    unknown = run_eval_unknown_skeleton.main(
        args[:3] + [str(tmp_path / "out_u")] + args[4:] + ["--n-calibration-samples", "3"])
    assert len(unknown) == 1 and np.isfinite(_artifact(tmp_path / "out_u")["calibrated_scale"])
