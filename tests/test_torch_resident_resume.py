"""A resident training run split over several sittings (``loop_snapshot``,
``resume``, ``stop_step``; ``resident_train train --state --stop-step``)
against the same run unsplit, on the CPU at a small config: the same
weights, BatchNorm stats, optimizer state, random streams and history, bit
for bit, with the augmentation on."""
import functools

import numpy as np
import pytest
import torch

from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict
from umetrack_torch.models import ModelConfig
from umetrack_torch.parallel import init_train_model, resident
from umetrack_torch.scripts import resident_train as rt
from umetrack_torch.utils.checkpoints import load_checkpoint
from umetrack_torch.utils.synthetic import scaled_hand_dict
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(start_planes=8, backbone_blocks=(1, 1, 1, 1), n_image_feature_channels=12,
             n_memory_channels=6)
N_TRAIN, N_EVAL, T, V, WINDOW, STEPS = 3, 2, 4, 2, 3, 4


def _entries(n, seed):
    """``prepare_tracker_sequences``-shaped entries made with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        view_valid = np.ones((T, 2, V), bool)
        view_valid[..., 1] = rng.random((T, 2)) < 0.7
        intr = np.tile(np.eye(3, dtype=np.float32), (T, 2, V, 1, 1))
        intr[..., 0, 0] = intr[..., 1, 1] = rng.uniform(150, 300, (T, 2, V))
        intr[..., 0, 2] = intr[..., 1, 2] = 47.5
        eye = np.tile(np.eye(4, dtype=np.float32), (T, 2, V, 1, 1))
        eye[..., :3, 3] = rng.standard_normal((T, 2, V, 3)) * 30.0
        eye[..., 2, 3] -= 300.0
        wrists = np.tile(np.eye(4, dtype=np.float32), (T, 2, 1, 1))
        wrists[..., :3, 3] = rng.standard_normal((T, 2, 3)) * 50.0
        scale = float(rng.uniform(0.85, 1.15))
        out.append(dict(
            images=rng.random((T, 2, V, 96, 96), dtype=np.float32),
            intrinsics=intr, T_world_from_eye=eye, view_valid=view_valid,
            hand_valid=np.ones((T, 2), bool), n_views=view_valid.sum(-1).astype(np.int32),
            angles=rng.uniform(-0.5, 0.5, (T, 2, 22)).astype(np.float32), wrists_mm=wrists,
            hand_model_mm=from_dict(scaled_hand_dict(load_generic_hand_dict(), scale)).map(
                lambda a: a.numpy()),
            scale=scale,
        ))
    return out


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume_cache")
    mp = pytest.MonkeyPatch()
    mp.setattr(rt, "CACHE", str(root))
    rt.save_entries(f"train_{N_TRAIN}_{T}", _entries(N_TRAIN, 0))
    rt.save_entries(f"eval_{N_EVAL}_{T}", _entries(N_EVAL, 1))
    mp.undo()
    return root


def _assert_same_state(a, b):
    """Two :func:`resident.loop_snapshot` s equal bit for bit, the history
    but for its wall-clock rate."""
    assert a["step"] == b["step"]
    assert a["model"].keys() == b["model"].keys()
    for key in a["model"]:
        assert torch.equal(a["model"][key], b["model"][key]), key
    assert a["optimizer"]["count"] == b["optimizer"]["count"]
    for (m1, v1), (m2, v2) in zip(a["optimizer"]["moments"], b["optimizer"]["moments"]):
        assert torch.equal(m1, m2) and torch.equal(v1, v2)
    assert a["rng"] == b["rng"]
    assert torch.equal(a["generator"], b["generator"])
    strip = [[{k: v for k, v in h.items() if k != "steps_per_s"} for h in s["history"]] for s in (a, b)]
    assert strip[0] == strip[1]


def _loop(cache, **kwargs):
    """``run_resident_training`` at the small config, augmented, a snapshot
    after every step; returns the snapshots by the step they continue at."""
    mp = pytest.MonkeyPatch()
    mp.setattr(rt, "CACHE", str(cache))
    corpus = rt.load_corpus(f"train_{N_TRAIN}_{T}", device="cpu")
    evalc = rt.load_corpus(f"eval_{N_EVAL}_{T}", device="cpu")
    mp.undo()
    snaps = {}
    model = init_train_model(ModelConfig(**SMALL), seed=0, device="cpu")
    resident.run_resident_training(
        model, corpus, eval_corpus=evalc, num_steps=STEPS, seqs_per_batch=2, window=WINDOW,
        log_every=1, eval_every=2, checkpoint_every=1,
        snapshot_fn=lambda s: snaps.setdefault(s["step"], s), **kwargs)
    return snaps


def test_loop_resumed_from_a_periodic_snapshot_equals_the_unsplit_loop(cache):
    """The killed-run case: a periodic snapshot (here after step 1) taken
    up by a new loop gives the unsplit loop's end state."""
    whole = _loop(cache)
    assert sorted(whole) == [2, 3, 4]
    resumed = _loop(cache, resume=whole[2])
    _assert_same_state(resumed[STEPS], whole[STEPS])
    stopped = _loop(cache, stop_step=3)
    _assert_same_state(stopped[3], whole[3])


def test_script_split_with_state_and_stop_step_equals_the_unsplit_run(cache, tmp_path, monkeypatch):
    """``resident_train train --state S --stop-step 2`` then the same
    command without ``--stop-step``: the unsplit run's checkpoint, history
    and state."""
    monkeypatch.setattr(rt, "CACHE", str(cache))
    monkeypatch.setattr(rt, "ModelConfig", functools.partial(ModelConfig, **SMALL))

    def run(name, *extra):
        out = tmp_path / name
        history = rt.main([
            "train", "--n-train", str(N_TRAIN), "--n-eval", str(N_EVAL), "--t", str(T),
            "--steps", str(STEPS), "--seqs-per-batch", "2", "--window", str(WINDOW),
            "--log-every", "1", "--eval-every", "2", "--dtype", "float32", "--device", "cpu",
            "--out-dir", str(out), "--ckpt", str(out / "run.msgpack"), "--state", str(out / "state.pt"),
            *extra])
        return out, history

    whole, history = run("whole")
    split, first = run("split", "--stop-step", "2")
    assert [h["step"] for h in first] == [0, 1]
    assert torch.load(split / "state.pt")["step"] == 2
    split, second = run("split")
    assert [h["step"] for h in second] == [h["step"] for h in history] == list(range(STEPS))
    _assert_same_state(torch.load(split / "state.pt"), torch.load(whole / "state.pt"))
    cfg = ModelConfig(**SMALL)
    a, b = load_checkpoint(str(split / "run.msgpack"), cfg), load_checkpoint(str(whole / "run.msgpack"), cfg)
    assert all(torch.equal(a[k], b[k]) for k in b)
