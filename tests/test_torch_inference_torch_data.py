"""Port parity for the torch_data inference slice as a whole: the port's
``_run_batch`` / ``run`` against the JAX app with the same weights (carried
over by ``from_flax_variables``), the same synthetic sequences and a small
config, on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umetrack_tpu.apps import run_inference_torch_data as japp
from umetrack_tpu.data import Split as JSplit
from umetrack_tpu.models import init_model, make_model as jmake_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_torch.apps import run_inference_torch_data as app
from umetrack_torch.apps.common import load_model_cli
from umetrack_torch.data import Split
from umetrack_torch.data.transform import parse_raw_buffers
from umetrack_torch.models import ModelConfig, UmeTrackNet, from_flax_variables
from umetrack_torch.utils.synthetic import make_torchdata_sample, write_torchdata_corpus
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)


@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig(**SMALL)
    jvars = jax.jit(lambda key: init_model(key, jcfg)[1])(jax.random.PRNGKey(7))
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars)
    rng = np.random.default_rng(2)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.random(a.shape) * 0.2).astype(np.float32), variables["batch_stats"]
    )
    cfg = ModelConfig(**SMALL)
    model = UmeTrackNet(cfg).eval()
    model.load_state_dict(from_flax_variables(variables, cfg))
    return model, jmake_model(jcfg), jax.tree_util.tree_map(jnp.asarray, variables)


def _items(lengths):
    items = []
    for i, t in enumerate(lengths):
        mono, labels = make_torchdata_sample(rng_seed=i, t=t, hand_idx=i % 2)
        items.append({"mono": mono, "labels": labels})
    return items


@pytest.mark.parametrize("n_views", [2, 1], ids=["multiv", "singlev"])
def test_run_batch_matches_jax_per_sample(models, n_views):
    model, jmodel, jvars = models
    items = _items([4, 4])
    ours = app._run_batch(model, items, (96, 96), n_views)
    ref = japp._run_batch(jmodel, jvars, items, (96, 96), n_views)
    assert ours.shape == (2,) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=0.1)  # mm


def test_singlev_ignores_view_1(models):
    model, _, _ = models
    items = _items([3])
    base = app._run_batch(model, items, n_views=1)
    items[0]["mono"] = items[0]["mono"].copy()
    items[0]["mono"][:, 1] = 0
    np.testing.assert_allclose(app._run_batch(model, items, n_views=1), base, atol=1e-4)
    assert abs(app._run_batch(model, items, n_views=2)[0] - base[0]) > 1e-4


def test_ragged_batch_matches_per_sequence(models):
    model, _, _ = models
    items = _items([3, 5, 2])
    batched = app._run_batch(model, items, (96, 96))
    assert batched.shape == (3,) and np.isfinite(batched).all()
    singles = [app._run_batch(model, [it], (96, 96))[0] for it in items]
    np.testing.assert_allclose(batched, np.asarray(singles), rtol=0, atol=2e-4)


def test_pad_raw_np_edge_semantics():
    item = _items([3])[0]
    raw = parse_raw_buffers(item["mono"], item["labels"])
    padded = app._pad_raw_np(raw, 8)
    assert padded.images.shape[0] == 8
    assert np.array_equal(padded.images[3], padded.images[7])
    assert np.array_equal(padded.images[:3], raw.images)
    assert padded.joint_angles.shape == (8, 22) and padded.hand.shape == (8,)
    # non-temporal leaves untouched
    assert padded.hand_model.joint_rotation_axes.shape == (22, 3)
    assert app._pad_raw_np(raw, 3) is raw


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    write_torchdata_corpus(str(root), n_train=1, n_test=5, t=3, device="cpu")
    return str(root)


def test_run_over_an_on_disk_tree_matches_jax(models, tree):
    model, jmodel, jvars = models
    ours = app.run(tree, model, batch_size=2, device="cpu", num_threads=2)
    assert set(ours) == {Split.TEST} and np.isfinite(ours[Split.TEST])
    ref = japp.run(tree, jvars, jmodel, batch_size=2, num_threads=2)
    assert abs(ours[Split.TEST] - ref[JSplit.TEST]) < 0.1
    both = app.run(tree, model, batch_size=4, device="cpu", splits=(Split.TEST, Split.TRAIN))
    assert set(both) == {Split.TEST, Split.TRAIN}
    assert abs(both[Split.TEST] - ours[Split.TEST]) < 1e-3
    # rank 1 of 2 sees sequences 1 and 3 (and the padded 0): another mean
    shard = app.run(tree, model, batch_size=2, device="cpu", distrib_info=(1, 2))
    assert np.isfinite(shard[Split.TEST])
    limited = app.run(tree, model, batch_size=2, device="cpu", limit_batches=1)
    assert np.isfinite(limited[Split.TEST]) and limited[Split.TEST] != ours[Split.TEST]


def test_main_prints_json_on_the_cpu(tree, capsys, monkeypatch):
    monkeypatch.setattr(app, "run", lambda roots, model, **kw: {Split.TEST: 1.5} if (
        kw["device"] == "cpu" and kw["n_views"] == 1 and kw["distrib_info"] == (0, 1)
        and model.config == ModelConfig()) else {})
    app.main(["--data", tree, "--device", "cpu", "--json", "--mode", "singlev", "--batch-size", "2"])
    assert capsys.readouterr().out.strip() == '{"testing": 1.5}'


def test_entry_points_need_cuda_unless_cpu_is_asked(models, tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        app.run(tree, models[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(["--data", tree])
    with pytest.raises(ValueError, match="CUDA"):
        app.run(tree, models[0], device="cpu", sampler="kernel_win")
    # a checkpoint loads (tests/test_torch_checkpoints.py, test_torch_orbax.py);
    # a missing file, a directory that is no checkpoint and a missing
    # directory raise, and no card still raises
    with pytest.raises(FileNotFoundError):
        load_model_cli("some.msgpack", device="cpu")
    with pytest.raises(ValueError, match="no orbax checkpoint"):
        load_model_cli(tree, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_model_cli("weights.bin", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model_cli("some.msgpack")
    with pytest.raises(SystemExit):
        app.main(["--data", tree, "--sampler", "pallas_win"])
