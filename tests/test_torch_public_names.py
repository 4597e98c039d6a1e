"""The JAX package's public names that the port carries under the same
name, each against the JAX package's on the CPU: the hand constants and
``Landmark``, ``default_sampler``, ``gen_crops_for_hand``, ``init_model``,
``convert_state_dict`` / ``load_torch_checkpoint``, the native reader's
``available`` / ``open_idxbin``, ``fetch_barrier``, the eval apps'
``DEFAULT_GENERIC_HAND`` and ``load_model``, and the apps' ``SAMPLERS``."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import synthetic
from umetrack_tpu.apps import common as jcommon
from umetrack_tpu.apps import run_eval_known_skeleton as jknown
from umetrack_tpu.apps import run_eval_unknown_skeleton as junknown
from umetrack_tpu.data import native as jnative
from umetrack_tpu.kinematics import hand as jhand
from umetrack_tpu.models import init_model as jinit_model
from umetrack_tpu.models import convert as jconvert
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.ops.resample import default_sampler as jdefault_sampler
from umetrack_tpu.tracker import TrackerConfig as JTrackerConfig
from umetrack_tpu.tracker.crops import gen_crops_for_hand as jgen_crops_for_hand
from umetrack_tpu.tracker.crops import static_crop_points_local as jstatic
from umetrack_torch.apps import common, run_eval_known_skeleton, run_eval_unknown_skeleton
from umetrack_torch.config import JAX_SAMPLERS
from umetrack_torch.data import native
from umetrack_torch.data.idxbin import IdxBinFile, write_idxbin
from umetrack_torch.kinematics import hand
from umetrack_torch.models import ModelConfig, from_flax_variables, init_model, make_model
from umetrack_torch.models.convert import (
    convert_state_dict,
    load_torch_checkpoint,
    reference_module_names,
    to_flax_variables,
)
from umetrack_torch.ops.resample import default_sampler
from umetrack_torch.tracker import TrackerConfig, gen_crops_for_hand
from umetrack_torch.tracker.crops import static_crop_points_local
from umetrack_torch.utils.profiling import fetch_barrier
from umetrack_torch.utils.synthetic import our_sequence
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5_CHECKPOINT = os.path.join(REPO, "checkpoints", "synthetic_r5.msgpack")
SMALL = dict(start_planes=8, backbone_blocks=(1, 1, 1, 1), n_image_feature_channels=12,
             n_memory_channels=6)


def test_hand_constants_and_landmarks_match_jax():
    for name in ("NUM_HANDS", "NUM_LANDMARKS_PER_HAND", "NUM_FINGERTIPS_PER_HAND",
                 "NUM_JOINTS_PER_HAND", "LEFT_HAND_INDEX", "RIGHT_HAND_INDEX", "NUM_DIGITS",
                 "NUM_JOINT_FRAMES", "DOF_PER_FINGER"):
        assert getattr(hand, name) == getattr(jhand, name), name
    assert [(m.name, m.value) for m in hand.Landmark] == [(m.name, m.value) for m in jhand.Landmark]
    assert len(hand.Landmark) == hand.NUM_LANDMARKS_PER_HAND


def test_default_sampler_names_the_devices_sampler():
    """The port's name for what the JAX package picks off its accelerator
    (``gather1d`` -> ``plain``), the windowed kernel on CUDA."""
    assert default_sampler("cpu") == JAX_SAMPLERS[jdefault_sampler()] == "plain"
    assert default_sampler(torch.device("cuda")) == "kernel_win"
    assert default_sampler() == ("kernel_win" if torch.cuda.is_available() else "plain")


@pytest.fixture(scope="module")
def sequences():
    labels, images = synthetic.make_labels_dict(2, rng_seed=11, mode="hand_hand", render=False)
    return synthetic.our_sequence(labels, images), our_sequence(labels, images, "cpu")


@pytest.mark.parametrize("hand_idx", [0, 1])
def test_gen_crops_for_hand_matches_jax(sequences, hand_idx):
    """One hand of frame 1 at ``tests/test_torch_crops.py``'s crop bounds;
    masks, indices and counts equal."""
    (jrig, jseq, jhand_model), (rig, seq, hand_model) = sequences
    t = 1
    ours = gen_crops_for_hand(
        rig, seq.T_world_from_camera[t], hand_model, seq.gt_joint_angles[t, hand_idx],
        seq.gt_wrist_xfs[t, hand_idx], seq.gt_confidences[t, hand_idx], hand_idx,
        TrackerConfig(), 1, static_crop_points_local(hand_model, 63)[hand_idx],
    )
    ref = jax.jit(jgen_crops_for_hand, static_argnames=("config", "min_num_crops"))(
        jrig, jseq.T_world_from_camera[t], jhand_model, jseq.gt_joint_angles[t, hand_idx],
        jseq.gt_wrist_xfs[t, hand_idx], jseq.gt_confidences[t, hand_idx], hand_idx,
        config=JTrackerConfig(), min_num_crops=1, static_pts_local=jstatic(jhand_model, 63)[hand_idx],
    )
    intr, t_we, src, vv, hand_valid, n_views = ours
    for name, a, b in (("src_idx", src, ref[2]), ("view_valid", vv, ref[3]),
                       ("hand_valid", hand_valid, ref[4]), ("n_views", n_views, ref[5])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    valid = np.asarray(ref[3])
    assert valid.any() and intr.shape == (2, 3, 3) and t_we.shape == (2, 4, 4)
    np.testing.assert_allclose(intr.numpy()[valid], np.asarray(ref[0])[valid], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(t_we.numpy()[valid], np.asarray(ref[1])[valid], rtol=1e-3, atol=5e-2)


def test_init_model_has_the_jax_variables_tree():
    """(model, state dict) seeded by a generator: the same weights as
    ``make_model`` at that seed, and as flax variables the JAX
    ``init_model``'s tree, leaf for leaf and shape for shape."""
    model, sd = init_model(torch.Generator().manual_seed(3), ModelConfig(**SMALL))
    assert not model.training
    ref = make_model(ModelConfig(**SMALL), seed=3).state_dict()
    assert all(torch.equal(sd[k], ref[k]) for k in ref)
    jvars = jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(0), JModelConfig(**SMALL))[1])
    ours = to_flax_variables(sd)
    jleaves = jax.tree_util.tree_flatten_with_path(jvars)[0]
    leaves = jax.tree_util.tree_flatten_with_path(ours)[0]
    assert [(jax.tree_util.keystr(p), tuple(v.shape)) for p, v in leaves] == \
        [(jax.tree_util.keystr(p), tuple(v.shape)) for p, v in jleaves]


@pytest.fixture(scope="module")
def reference_file(tmp_path_factory):
    """A ``.torch`` state dict under the original model's module names
    (seeded weights at the full width of ``ModelConfig()``)."""
    names = {ours: ref for ref, ours in reference_module_names().items()}
    sd = {}
    for key, value in make_model(ModelConfig(), seed=5).state_dict().items():
        path, leaf = key.rsplit(".", 1)
        sd[f"{names[path]}.{leaf}"] = value
    path = str(tmp_path_factory.mktemp("reference") / "weights.torch")
    torch.save(sd, path)
    return path, sd


def _assert_state_equal(a, b):
    assert set(a) == set(b)
    for key in b:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(), err_msg=key)


def test_convert_state_dict_and_load_torch_checkpoint_match_jax(reference_file):
    path, sd = reference_file
    jvars = jconvert.convert_state_dict({k: v.numpy() for k, v in sd.items()})
    want = from_flax_variables(jax.tree_util.tree_map(np.asarray, jvars), ModelConfig())
    _assert_state_equal(convert_state_dict(sd), want)
    jloaded = jax.tree_util.tree_map(np.asarray, jconvert.load_torch_checkpoint(path))
    _assert_state_equal(load_torch_checkpoint(path), from_flax_variables(jloaded, ModelConfig()))


def test_open_idxbin_reads_what_the_jax_reader_reads(tmp_path, monkeypatch):
    """Native where the library builds, the Python reader where it does
    not; the frames equal the JAX ``open_idxbin``'s either way."""
    frames = np.random.default_rng(0).integers(0, 255, (3, 4, 5), dtype=np.uint8)
    write_idxbin(str(tmp_path / "mono"), frames)
    idx = str(tmp_path / "mono.torch.idx")
    want = jnative.open_idxbin(idx)
    assert native.available()
    reader = native.open_idxbin(idx)
    assert isinstance(reader, native.NativeIdxBin)

    def no_library():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(native, "load_library", no_library)
    assert not native.available()
    fallback = native.open_idxbin(idx)
    assert isinstance(fallback, IdxBinFile)
    for r in (reader, fallback):
        assert len(r) == len(want) == 3
        for i in range(3):
            np.testing.assert_array_equal(np.asarray(r[i]), np.asarray(want[i]))
    reader.close()


def test_fetch_barrier_takes_any_tree():
    tree = {"a": torch.zeros(2), "b": [torch.ones(1), (torch.arange(3), None)], "c": 1.0}
    assert fetch_barrier(tree) is None
    assert fetch_barrier() is None
    assert fetch_barrier(hand.from_dict(hand.load_generic_hand_dict())) is None


def test_eval_app_names_match_jax():
    assert os.path.samefile(run_eval_unknown_skeleton.DEFAULT_GENERIC_HAND, junknown.DEFAULT_GENERIC_HAND)
    # every single-image sampler of the JAX apps that the port maps has its
    # port name among the port apps' samplers
    mapped = [JAX_SAMPLERS[name] for name in jcommon.SAMPLERS if name in JAX_SAMPLERS]
    assert mapped and set(mapped) <= set(common.SAMPLERS)


def test_load_model_matches_jax():
    """The round-5 checkpoint through either app's ``load_model``: the same
    weights, on the CPU, in eval mode."""
    model = run_eval_known_skeleton.load_model(R5_CHECKPOINT, device="cpu")
    assert not model.training and next(model.parameters()).device.type == "cpu"
    _, jvars = jknown.load_model(R5_CHECKPOINT)
    want = from_flax_variables(jax.tree_util.tree_map(np.asarray, jvars), ModelConfig())
    _assert_state_equal({k: v for k, v in model.state_dict().items() if k in want}, want)


GENERIC_HAND_CHECK = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from umetrack_tpu.utils import synthetic as jsynthetic
from umetrack_torch.kinematics import hand
from umetrack_torch.utils import synthetic
path = sys.argv[1]
assert synthetic.GENERIC_HAND_JSON == hand.GENERIC_HAND_JSON == jsynthetic.GENERIC_HAND_JSON == path
loaded = [hand.load_generic_hand_dict(), synthetic.load_generic_hand_dict(), jsynthetic.load_generic_hand_dict()]
assert loaded[0] == loaded[1] == loaded[2] == json.load(open(path))
labels, _ = synthetic.make_labels_dict(4, rng_seed=0, render=False, device="cpu")
jlabels, _ = jsynthetic.make_labels_dict(4, rng_seed=0, render=False)
for key, want in jlabels["hand_model"].items():
    np.testing.assert_array_equal(np.asarray(labels["hand_model"][key]), np.asarray(want), err_msg=key)
np.testing.assert_array_equal(np.asarray(labels["hand_model"]["joint_rest_positions"]),
                              np.asarray(loaded[0]["joint_rest_positions"]))
print("same hand")
"""


def test_generic_hand_json_variable_is_read_like_the_jax_package(tmp_path):
    """``UMETRACK_GENERIC_HAND_JSON`` names the generic hand for both
    packages (``utils/synthetic.py``): with it set to a scaled copy of the
    vendored hand, both load that copy and both generate its labels; the
    unknown-skeleton app's default stays the vendored file."""
    from umetrack_torch.utils.synthetic import scaled_hand_dict

    path = tmp_path / "scaled_hand.json"
    path.write_text(json.dumps(scaled_hand_dict(hand.load_generic_hand_dict(hand.VENDORED_HAND_JSON), 1.2)))
    env = dict(os.environ, UMETRACK_GENERIC_HAND_JSON=str(path), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    done = subprocess.run([sys.executable, "-c", GENERIC_HAND_CHECK, str(path)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0 and "same hand" in done.stdout, done.stderr[-3000:]
    assert run_eval_unknown_skeleton.DEFAULT_GENERIC_HAND == hand.VENDORED_HAND_JSON
    assert os.path.samefile(hand.VENDORED_HAND_JSON, os.path.join(REPO, "assets", "generic_hand_model.json"))
