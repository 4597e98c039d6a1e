"""Port parity of the training app (``umetrack_torch.apps.train``) and the
config tree (``umetrack_torch.config``) against the JAX package, on the
CPU: config files in both directions, batch building on the same raw
sequences, the tracker-domain material, the loop with its ``.msgpack``
checkpoints (which the JAX package loads), and the idx/bin loader."""
import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umetrack_tpu import config as jconfig
from umetrack_tpu.apps import train as japp
from umetrack_torch import config
from umetrack_torch.apps import train as app
from umetrack_torch.models import ModelConfig
from umetrack_torch.utils.synthetic import make_torchdata_sample, write_torchdata_corpus
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)


def close(a, b, **tol):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


def test_config_round_trip_and_defaults(tmp_path):
    cfg = config.Config()
    path = str(tmp_path / "cfg.json")
    config.to_json(cfg, path)
    assert config.from_json(path) == cfg
    assert config.from_json(config.to_json(cfg)) == cfg
    # the same fields and defaults as the JAX package, tracker knobs aside
    theirs = json.loads(jconfig.to_json(jconfig.Config()))
    ours = json.loads(config.to_json(cfg))
    for knob in config.TPU_TRACKER_KNOBS:
        theirs["tracker"].pop(knob)
    assert ours == theirs


def test_a_jax_written_config_loads(tmp_path, caplog):
    cfg = jconfig.Config(
        model=jconfig.ModelConfig(**SMALL),
        tracker=jconfig.TrackerConfig(sampler="pallas_pool", pool_sublanes=16),
        data=jconfig.DataConfig(data_roots=("/data/a", "/data/b"), batch_size=4),
        train=jconfig.TrainConfig(learning_rate=3e-4, lr_schedule="cosine", tbptt_window=8),
    )
    path = str(tmp_path / "jax.json")
    jconfig.to_json(cfg, path)
    with caplog.at_level(logging.INFO, logger="umetrack_torch.config"):
        ours = config.from_json(path)
    assert "pool_sublanes" in caplog.text
    assert ours.model == ModelConfig(**SMALL)
    assert ours.tracker.sampler == "kernel" and ours.tracker.crop_size == (96, 96)
    assert ours.data.data_roots == ("/data/a", "/data/b") and ours.data.batch_size == 4
    assert ours.train.lr_schedule == "cosine" and ours.train.tbptt_window == 8
    for name, port_name in config.JAX_SAMPLERS.items():
        d = json.loads(jconfig.to_json(jconfig.Config(tracker=jconfig.TrackerConfig(sampler=name))))
        assert config.from_json(json.dumps(d)).tracker.sampler == port_name


@pytest.mark.parametrize("bad, error", [
    ({"tracker": {"sampler": "gather2d"}}, ValueError),
    ({"train": {"learning_rte": 1.0}}, KeyError),
    ({"trainer": {}}, KeyError),
    ({"mesh": {"model_axis": -1}}, ValueError),
])
def test_config_rejects_what_it_cannot_run(bad, error):
    with pytest.raises(error):
        config.from_json(json.dumps(bad))


@pytest.mark.parametrize("model_axis", [0, 2])
def test_config_accepts_the_model_axis(model_axis):
    """0 (auto) and 2 load, as the JAX app's config takes them; the mesh
    they give is made by ``run_training`` (tests/test_torch_tp.py)."""
    ours = config.from_json(json.dumps({"mesh": {"model_axis": model_axis}}))
    assert ours.mesh.model_axis == model_axis
    assert config.from_json(config.to_json(ours)) == ours


def _raw_items(n, t):
    return [dict(zip(("mono", "labels"), make_torchdata_sample(rng_seed=40 + i, t=t, hand_idx=i % 2)))
            for i in range(n)]


def _compare_frames(ours, ref):
    close(ours.images, ref.images, atol=2e-3)
    close(ours.intrinsics, ref.intrinsics, rtol=1e-4, atol=1e-4)
    close(ours.extrinsics, ref.extrinsics, rtol=1e-3, atol=1e-4)
    for field in ("n_views", "hand_idx", "use_memory"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(), np.asarray(getattr(ref, field)))


@pytest.mark.parametrize("window, t0", [(1, None), (3, None), (3, 4)])
def test_batches_match_jax(window, t0):
    """``_build_train_batch`` / ``_build_temporal_batch`` on the same raw
    sequences (t=6): frames within the torch_data tests' bounds, targets
    and skeletons exact to f32 rounding."""
    items = _raw_items(3, 6)
    ours = app._batch_from_sequences(items, (96, 96), window, t0, device="cpu")
    ref = japp._batch_from_sequences(items, (96, 96), window, None if t0 is None else jnp.asarray(t0))
    if window == 1:
        assert isinstance(ours, app.TrainBatch)
        _compare_frames(ours.frame, ref.frame)
    else:
        assert isinstance(ours, app.TemporalTrainBatch) and ours.frames.images.shape[:2] == (3, 3)
        _compare_frames(ours.frames, ref.frames)
    close(ours.gt_joint_angles, ref.gt_joint_angles, rtol=1e-6, atol=1e-7)
    close(ours.gt_wrist_world, ref.gt_wrist_world, rtol=1e-5, atol=1e-6)
    close(ours.gt_scales, ref.gt_scales, rtol=1e-6)
    close(ours.skeleton.joint_rest_positions, ref.skeleton.joint_rest_positions, rtol=1e-5, atol=1e-7)
    close(ours.hand.landmark_rest_positions, ref.hand.landmark_rest_positions, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def entries():
    """Two rendered sequences of 2 frames (separate, then hand_hand) through
    the port's tracker prep on the CPU."""
    return app.prepare_tracker_sequences(n_seqs=2, t=2, seed0=5000, device="cpu")


def test_prepare_tracker_sequences(entries):
    """The crops are ordinary numpy arrays on the tracker's geometry; the
    GT comes from the same label generator as the JAX package's."""
    from umetrack_tpu.utils import synthetic as jsynthetic

    assert len(entries) == 2
    for i, e in enumerate(entries):
        assert isinstance(e["images"], np.ndarray) and e["images"].shape == (2, 2, 2, 96, 96)
        assert np.isfinite(e["images"]).all() and 0.0 <= e["images"].min() and e["images"].max() <= 1.0
        assert e["hand_valid"].shape == (2, 2) and e["n_views"].shape == (2, 2)
        assert e["T_world_from_eye"].shape == (2, 2, 2, 4, 4)
        rng = np.random.default_rng(5000 + i)
        scale = float(rng.uniform(0.85, 1.15))
        assert e["scale"] == scale
        labels, _ = jsynthetic.make_labels_dict(
            2, rng_seed=5000 + i, with_dropout=False, mode="hand_hand" if i % 2 else "separate",
            hand_scale=scale, render=False,
        )
        np.testing.assert_array_equal(e["angles"], np.asarray(labels["joint_angles"], np.float32))
        np.testing.assert_array_equal(e["wrists_mm"], np.asarray(labels["wrist_transforms"], np.float32))
        np.testing.assert_allclose(e["hand_model_mm"].joint_rest_positions,
                                   np.asarray(labels["hand_model"]["joint_rest_positions"], np.float32),
                                   rtol=1e-6)
        assert e["hand_valid"].any()


def test_tracker_domain_batches_match_jax(entries):
    """The host assembly of TBPTT batches, on the same entries in both."""
    from umetrack_tpu.kinematics.hand import HandModel as JHandModel

    jentries = [dict(e, hand_model_mm=JHandModel(**dataclasses.asdict(e["hand_model_mm"])))
                for e in entries]
    ours = next(app.tracker_domain_batches(entries, seqs_per_batch=2, window=2, seed=7, device="cpu"))
    ref = next(japp.tracker_domain_batches(jentries, seqs_per_batch=2, window=2, seed=7))
    _compare_frames(ours.frames, ref.frames)
    for field in ("gt_joint_angles", "gt_wrist_world", "gt_scales"):
        close(getattr(ours, field), getattr(ref, field), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    close(ours.skeleton.joint_rest_positions, ref.skeleton.joint_rest_positions, rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A short synthetic run of the loop at a small config with
    checkpoints."""
    ckpts = tmp_path_factory.mktemp("ckpts")
    cfg = config.Config(
        model=ModelConfig(**SMALL),
        train=config.TrainConfig(
            learning_rate=3e-4, batch_size=4, num_steps=12, log_every=2,
            checkpoint_dir=str(ckpts), checkpoint_every=10, lr_schedule="cosine", warmup_steps=2,
        ),
    )
    state, history = app.run_training(
        cfg, app.synthetic_batches(4, (96, 96), device="cpu"), device="cpu"
    )
    return cfg, state, history, str(ckpts)


def test_run_training_learns_and_writes_msgpack_checkpoints(trained):
    cfg, state, history, ckpts = trained
    assert len(history) == 7 and all(np.isfinite(history))
    assert history[-1] < history[0], history
    assert state.step == 12 and state.optimizer.count == 12
    # the JAX app's names: orbax directories step_{step:07d} and final
    assert sorted(os.listdir(ckpts)) == ["final", "step_0000010"]
    for name in ("final", "step_0000010"):
        assert {"_METADATA", "manifest.ocdbt", "d"} <= set(os.listdir(os.path.join(ckpts, name)))


@pytest.mark.parametrize("name", ["final", "explicit.msgpack"])
def test_a_port_trained_checkpoint_runs_in_the_jax_package(trained, tmp_path, name):
    """The train app's ``final`` directory (through orbax) and an explicit
    ``.msgpack`` save of the same weights (through flax) load in the JAX
    package, and its eval-mode forward equals the port's on the same frame
    (the model tests' bounds)."""
    from umetrack_tpu.models import init_model, make_model
    from umetrack_tpu.models.config import ModelConfig as JModelConfig
    from umetrack_tpu.models.umetrack import FrameInputs as JFrame
    from umetrack_tpu.models.umetrack import SkeletonInputs as JSkel
    from umetrack_tpu.models.umetrack import TemporalState as JState
    from umetrack_tpu.models.umetrack import UmeTrackNet as JNet
    from umetrack_tpu.utils.checkpoints import load_checkpoint as jload
    from umetrack_torch.models import TemporalState
    from umetrack_torch.utils.checkpoints import load_checkpoint, save_checkpoint

    cfg, state, _, ckpts = trained
    model = state.model.eval()
    if name == "final":
        path = os.path.join(ckpts, name)
    else:
        path = save_checkpoint(str(tmp_path / name), model.state_dict())
        with open(path, "rb") as fp:
            assert fp.read(1) == b"\x82"  # a msgpack map of two entries, not a directory
    loaded = load_checkpoint(path, cfg.model)
    assert all(torch.equal(v, loaded[k]) for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    jcfg = JModelConfig(**SMALL)
    template = jax.jit(lambda key: init_model(key, jcfg)[1])(jax.random.PRNGKey(0))
    jvars = jload(path, template)

    batch = next(app.synthetic_batches(3, (96, 96), device="cpu"))
    with torch.no_grad():
        out, _ = model.known_skeleton(batch.frame, batch.skeleton, TemporalState.zeros(3, cfg.model))
    jout, _ = make_model(jcfg).apply(
        jvars,
        JFrame(**{f: jnp.asarray(getattr(batch.frame, f).numpy())
                  for f in batch.frame.__dataclass_fields__}),
        JSkel(joint_rotation_axes=jnp.asarray(batch.skeleton.joint_rotation_axes.numpy()),
              joint_rest_positions=jnp.asarray(batch.skeleton.joint_rest_positions.numpy())),
        JState.zeros(3, jcfg), method=JNet.known_skeleton,
    )
    close(out.joint_angles, jout.joint_angles, rtol=1e-4, atol=1e-4)
    close(out.wrist_xfs, jout.wrist_xfs, rtol=1e-4, atol=1e-4)
    close(out.landmark_uncertainty_sigmas, jout.landmark_uncertainty_sigmas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [1, 2])
def test_dataset_batches_on_an_idxbin_tree(tmp_path, window):
    write_torchdata_corpus(str(tmp_path), n_train=3, n_test=0, t=2, device="cpu")
    cfg = config.Config(
        data=config.DataConfig(data_roots=(str(tmp_path),), num_io_threads=2),
        train=config.TrainConfig(batch_size=3, tbptt_window=window),
    )
    batch = next(app.dataset_batches(cfg, device="cpu"))
    images = batch.frame.images if window == 1 else batch.frames.images
    assert tuple(images.shape) == ((3, 2, 96, 96) if window == 1 else (3, 2, 2, 96, 96))
    assert torch.isfinite(batch.gt_joint_angles).all() and torch.isfinite(images).all()


def test_main_runs_on_the_cpu_and_needs_a_card_by_default(tmp_path, monkeypatch, capsys):
    app.main(["--print-config", "--steps", "3", "--window", "4"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["train"]["num_steps"] == 3 and printed["train"]["tbptt_window"] == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.main(["--synthetic", "--steps", "1"])
