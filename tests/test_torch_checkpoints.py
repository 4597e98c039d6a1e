"""Port parity for the checkpoint path: the port's msgpack codec against
flax's serialization, ``utils/checkpoints.py`` and ``models/convert.py``
(both directions and the original model's names), and the committed
trained checkpoint at the full width of ``ModelConfig()``: the port's two
heads against the JAX model with the same file loaded by the JAX package.
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import serialization

from umetrack_tpu.models import init_model
from umetrack_tpu.models.convert import convert_state_dict
from umetrack_tpu.models.umetrack import FrameInputs as JFrame
from umetrack_tpu.models.umetrack import SkeletonInputs as JSkel
from umetrack_tpu.models.umetrack import TemporalState as JState
from umetrack_tpu.models.umetrack import UmeTrackNet as JNet
from umetrack_tpu.utils.checkpoints import load_checkpoint as jload_checkpoint
from umetrack_torch.apps.common import load_model_cli
from umetrack_torch.data import _msgpack
from umetrack_torch.models import (
    FrameInputs,
    ModelConfig,
    SkeletonInputs,
    TemporalState,
    UmeTrackNet,
    from_flax_variables,
    make_model,
)
from umetrack_torch.models.convert import (
    from_reference_state_dict,
    reference_module_names,
    to_flax_variables,
)
from umetrack_torch.utils.checkpoints import load_checkpoint, save_checkpoint
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "synthetic.msgpack")
RTOL = ATOL = 1e-4  # tests/test_torch_model.py's
SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
B = 2

TREES = {
    "arrays": {
        "params": {"w": np.arange(24, dtype=np.float32).reshape(2, 3, 4), "b": np.zeros(3, np.float32)},
        "batch_stats": {"mean": np.ones((5,), np.float32)},
    },
    # payloads of 8 and 16 bytes (the fixed-length extension headers), an
    # empty array, a 0-d array, other dtypes
    "odd_sizes": {
        "empty": np.zeros((0, 3), np.float32), "scalar": np.asarray(3, np.int32),
        "u8": np.arange(3, dtype=np.uint8), "u8_11": np.arange(11, dtype=np.uint8),
        "f64": np.linspace(0, 1, 7), "bool": np.asarray([True, False]),
        "i64": np.arange(300, dtype=np.int64).reshape(3, 100),
    },
    "mixed": {"step": 7, "name": "x", "nested": {"lr": 0.5, "flag": True, "none": None, "a": np.eye(2, dtype=np.float32)}},
}


def _assert_tree_equal(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(TREES))
def test_packb_equals_flax_to_bytes(name):
    tree = TREES[name]
    assert _msgpack.packb(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("name", sorted(TREES))
def test_unpackb_equals_flax_msgpack_restore(name):
    data = serialization.to_bytes(TREES[name])
    ours = _msgpack.unpackb(data)
    _assert_tree_equal(ours, serialization.msgpack_restore(data))
    _assert_tree_equal(ours, _msgpack.unpackb(_msgpack.packb(ours)))


@pytest.mark.parametrize("value, what", [(np.float32(1.5), "numpy scalar"), (1 + 2j, "complex")])
def test_other_flax_extension_types_raise_by_name(value, what):
    data = serialization.msgpack_serialize({"x": value})
    with pytest.raises(ValueError, match=what):
        _msgpack.unpackb(data)


def test_unpacked_arrays_own_their_memory():
    data = bytearray(serialization.to_bytes(TREES["arrays"]))
    w = _msgpack.unpackb(data)["params"]["w"]
    data[:] = bytes(len(data))
    np.testing.assert_array_equal(w, TREES["arrays"]["params"]["w"])
    assert w.flags.writeable
    torch.from_numpy(w)  # no warning about a read-only buffer


def test_committed_checkpoint_reads_like_flax_and_round_trips(tmp_path):
    with open(CKPT, "rb") as fp:
        data = fp.read()
    tree = _msgpack.unpackb(data)
    _assert_tree_equal(tree, serialization.msgpack_restore(data))
    assert len(jax.tree_util.tree_leaves(tree)) == 213
    assert _msgpack.packb(tree) == data
    # load -> save writes the same bytes; save -> load is exact
    sd = load_checkpoint(CKPT)
    out = save_checkpoint(str(tmp_path / "sub" / "copy.msgpack"), sd)
    with open(out, "rb") as fp:
        assert fp.read() == data
    again = load_checkpoint(out)
    assert list(again) == list(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


def test_to_flax_variables_inverts_from_flax_variables():
    cfg = ModelConfig(**SMALL)
    model = make_model(cfg, seed=3)
    sd = model.state_dict()
    variables = to_flax_variables(sd)
    assert list(variables) == ["params", "batch_stats"]
    assert "num_batches_tracked" not in str(jax.tree_util.tree_structure(variables))
    assert variables["params"]["backbone"]["stem_conv"]["kernel"].shape == (3, 3, 1, 8)  # HWIO
    assert variables["params"]["skeleton_encoder"]["linear"]["kernel"].shape[0] == 132  # (in, out)
    back = from_flax_variables(variables, cfg)
    assert set(back) == set(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # the same bytes as flax writes for the same tree
    assert _msgpack.packb(variables) == serialization.to_bytes(variables)


def test_orbax_directory_unknown_suffix_and_wrong_shapes_raise(tmp_path):
    # any path but .msgpack / .torch is an orbax directory (the JAX package's rule)
    with pytest.raises(ValueError, match="no orbax checkpoint"):
        load_checkpoint(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "weights.bin"))
    with pytest.raises(ValueError, match="do not fit the config"):
        load_checkpoint(CKPT, ModelConfig(**SMALL))
    bad = str(tmp_path / "bad.msgpack")
    with open(bad, "wb") as fp:
        fp.write(_msgpack.packb({"weights": {}}))
    with pytest.raises(ValueError, match="params"):
        load_checkpoint(bad)
    with pytest.raises(ValueError, match="no arrays"):
        save_checkpoint(str(tmp_path / "ckpt_dir"), {})
    with pytest.raises(ValueError, match="torch"):
        save_checkpoint(str(tmp_path / "state.torch"), make_model(ModelConfig(**SMALL)).state_dict())


def test_reference_state_dict_goes_through_the_name_map(tmp_path):
    """A state dict under the original model's names: the port's rename
    equals the JAX package's ``convert_state_dict`` followed by
    ``from_flax_variables``, and a ``.torch`` file loads through it."""
    cfg = ModelConfig(**SMALL)
    from umetrack_tpu.models.config import ModelConfig as JModelConfig

    model = make_model(cfg, seed=4)
    ours_to_ref = {v: k for k, v in reference_module_names(cfg).items()}
    ref_sd = {}
    for key, value in model.state_dict().items():
        path, leaf = key.rsplit(".", 1)
        ref_sd[f"{ours_to_ref[path]}.{leaf}"] = value
    renamed = from_reference_state_dict(ref_sd, cfg)
    via_jax = from_flax_variables(
        convert_state_dict({k: v.numpy() for k, v in ref_sd.items()}, JModelConfig(**SMALL)), cfg
    )
    assert set(renamed) == set(via_jax) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(renamed[k], v), k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(via_jax[k], v), k
    with pytest.raises(ValueError, match="no counterpart"):
        from_reference_state_dict({**ref_sd, "_extra.weight": torch.zeros(1)}, cfg)

    full = make_model(ModelConfig(), seed=5)
    names = {v: k for k, v in reference_module_names().items()}
    path = str(tmp_path / "pretrained_weights.torch")
    torch.save({f"{names[k.rsplit('.', 1)[0]]}.{k.rsplit('.', 1)[1]}": v
                for k, v in full.state_dict().items()}, path)
    loaded = load_checkpoint(path)
    for k, v in full.state_dict().items():
        assert torch.equal(loaded[k], v), k


# ---- the committed checkpoint at full width against the JAX package ----------


@pytest.fixture(scope="module")
def full_width():
    jmodel, jvars = init_model(jax.random.PRNGKey(0))
    jvars = jload_checkpoint(CKPT, jvars)
    model = load_model_cli(CKPT, device="cpu")
    assert not model.training and model.config == ModelConfig()
    rng = np.random.default_rng(2)
    k = np.tile(np.eye(3, dtype=np.float32), (B, 2, 1, 1))
    k[..., 0, 0] = k[..., 1, 1] = rng.uniform(150, 250, (B, 2))
    k[..., 0, 2] = k[..., 1, 2] = 47.5
    extr = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    for b in range(B):
        for v in range(2):
            q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            extr[b, v, :3, :3] = q * np.sign(np.linalg.det(q))
    extr[..., :3, 3] = rng.uniform(-0.3, 0.3, (B, 2, 3))
    x = dict(
        images=rng.random((B, 2, 96, 96), dtype=np.float32),
        intrinsics=k,
        extrinsics=extr,
        n_views=np.asarray([2, 1], np.int32),
        hand_idx=np.asarray([0, 1], np.int32),
        use_memory=np.asarray([True, False]),
    )
    mem = (rng.standard_normal((B, 6, 6, 18)) * 0.1).astype(np.float32)  # NHWC
    prev = extr[:, 1].copy()
    names = tuple(x)
    return dict(
        jmodel=jmodel, jvars=jvars, model=model,
        jframe=JFrame(**{n: jnp.asarray(x[n]) for n in names}),
        frame=FrameInputs(**{n: torch.from_numpy(x[n]) for n in names}),
        jstate=JState(jnp.asarray(mem), jnp.asarray(prev)),
        state=TemporalState(torch.from_numpy(np.moveaxis(mem, -1, 1).copy()), torch.from_numpy(prev)),
        axes=rng.standard_normal((B, 22, 3)).astype(np.float32),
        rest=(rng.standard_normal((B, 22, 3)) * 0.05).astype(np.float32),
    )


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_checkpoint_known_skeleton_matches_jax_at_full_width(full_width):
    f = full_width
    jout, jnew = f["jmodel"].apply(
        f["jvars"], f["jframe"], JSkel(jnp.asarray(f["axes"]), jnp.asarray(f["rest"])),
        f["jstate"], method=JNet.known_skeleton,
    )
    with torch.no_grad():
        out, new = f["model"].known_skeleton(
            f["frame"], SkeletonInputs(torch.from_numpy(f["axes"]), torch.from_numpy(f["rest"])),
            f["state"],
        )
    _close(out.joint_angles, jout.joint_angles)
    _close(out.wrist_xfs, jout.wrist_xfs)
    _close(out.landmark_uncertainty_sigmas, jout.landmark_uncertainty_sigmas)
    _close(new.mem_features, np.moveaxis(np.asarray(jnew.mem_features), -1, 1))
    assert out.skel_scales is None


def test_checkpoint_predict_scale_matches_jax_at_full_width(full_width):
    f = full_width
    jout, jnew = f["jmodel"].apply(f["jvars"], f["jframe"], f["jstate"], method=JNet.predict_scale)
    with torch.no_grad():
        out, new = f["model"].predict_scale(f["frame"], f["state"])
    _close(out.joint_angles, jout.joint_angles)
    _close(out.wrist_xfs, jout.wrist_xfs)
    _close(out.skel_scales, jout.skel_scales)
    _close(new.mem_features, np.moveaxis(np.asarray(jnew.mem_features), -1, 1))
    _close(new.prev_extrinsics, jnew.prev_extrinsics)
    # a trained scale head does not answer 1 on arbitrary input
    assert (np.abs(out.skel_scales.numpy() - 1.0) > 1e-3).any()


def test_predict_scale_matches_jax_with_random_weights():
    """The scale head at a small width with seeded random weights (scales
    near 1), the same weights in both packages."""
    from umetrack_tpu.models import make_model as jmake_model
    from umetrack_tpu.models.config import ModelConfig as JModelConfig

    jcfg = JModelConfig(**SMALL)
    jvars = jax.jit(lambda key: init_model(key, jcfg)[1])(jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    # off flax's start (every bias 0), or the head answers exp(~0) = 1
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.standard_normal(a.shape) * 0.05).astype(np.float32), jvars
    )
    variables["batch_stats"] = jax.tree_util.tree_map(np.abs, variables["batch_stats"])
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    cfg = ModelConfig(**SMALL)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    model.eval()
    x = dict(
        images=rng.random((B, 2, 96, 96), dtype=np.float32),
        intrinsics=np.tile(np.asarray([[200.0, 0, 47.5], [0, 200.0, 47.5], [0, 0, 1]], np.float32), (B, 2, 1, 1)),
        extrinsics=np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1)),
        n_views=np.asarray([2, 2], np.int32),
        hand_idx=np.asarray([0, 1], np.int32),
        use_memory=np.asarray([False, False]),
    )
    x["extrinsics"][:, 1, 0, 3] = 0.1
    jout, _ = jmake_model(jcfg).apply(
        jvars, JFrame(**{n: jnp.asarray(a) for n, a in x.items()}),
        JState.zeros(B, jcfg), method=JNet.predict_scale,
    )
    with torch.no_grad():
        out, _ = model.predict_scale(
            FrameInputs(**{n: torch.from_numpy(a) for n, a in x.items()}), TemporalState.zeros(B, cfg)
        )
    _close(out.skel_scales, jout.skel_scales)
    _close(out.joint_angles, jout.joint_angles)
    _close(out.wrist_xfs, jout.wrist_xfs)
    off_one = np.abs(out.skel_scales.numpy() - 1.0)
    assert np.all(off_one < 0.5) and np.all(off_one > 1e-4)
