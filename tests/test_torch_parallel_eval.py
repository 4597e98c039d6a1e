"""Port parity of the batched evaluation (``umetrack_torch/parallel/eval.py``)
against the JAX package's ``parallel/eval.py`` on the CPU, mirroring
``tests/test_parallel.py``'s eval tests: S=4 sequences of T=4 frames from
``make_labels_dict`` (seeds 20-23, smooth-noise frames: the tracker's
crops come from the GT pose either way), the JAX weights carried across by
``from_flax_variables``, the small config of the other port tests; and
the port's mesh and ``MeshConfig`` rules."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import synthetic
from conftest import GENERIC_HAND_JSON
from umetrack_tpu.kinematics.hand import load_hand_model_json as jload_hand
from umetrack_tpu.models import init_model, make_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.parallel import eval as jeval
from umetrack_tpu.tracker import TrackerConfig as JTrackerConfig
from umetrack_torch import config
from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict, stack_hand_models
from umetrack_torch.models import ModelConfig, UmeTrackNet, from_flax_variables
from umetrack_torch.parallel import eval as peval
from umetrack_torch.parallel import make_mesh, shard_batch
from umetrack_torch.parallel.mesh import Mesh
from umetrack_torch.tracker import HandTracker, TrackerConfig
from umetrack_torch.tracker.tracker import track_sequences_batched
from umetrack_torch.tracker.types import CameraRig, FrameObservation
from umetrack_torch.utils.synthetic import our_sequence
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
S, T = 4, 4
N_CALIBRATION = 6
MM_TOL = 0.1  # per-sequence errors, the JAX tests' wrist bound
MEAN_RTOL = 1e-4
SCALE_TOL = 2e-3


def _stack(trees, cls):
    return cls(**{k: torch.stack([getattr(tr, k) for tr in trees]) for k in trees[0].__dataclass_fields__})


@pytest.fixture(scope="module")
def setup():
    jcfg = JModelConfig(**SMALL)
    jvars = jax.jit(lambda key: init_model(key, jcfg)[1])(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars)
    cfg = ModelConfig(**SMALL)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    model.eval()
    jparts, parts = [], []
    for i in range(S):
        labels, images = synthetic.make_labels_dict(T, rng_seed=20 + i, render=False)
        jparts.append(synthetic.our_sequence(labels, images))
        parts.append(our_sequence(labels, images, "cpu"))
    jstack = lambda xs: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *xs)
    return dict(
        jmodel=make_model(jcfg), jvars=jax.tree_util.tree_map(jnp.asarray, variables),
        jinputs=tuple(jstack([p[k] for p in jparts]) for k in range(3)),
        model=model,
        inputs=(_stack([p[0] for p in parts], CameraRig), _stack([p[1] for p in parts], FrameObservation),
                stack_hand_models([p[2] for p in parts])),
    )


@pytest.fixture(scope="module")
def port_known(setup):
    rigs, seqs, hands = setup["inputs"]
    model = setup["model"]
    return peval.eval_sequences_batched(
        model, TrackerConfig(), rigs, seqs, peval.make_batched_state(model, S, "cpu"), hands,
        device="cpu",
    )


def test_batched_eval_matches_jax(setup, port_known):
    rigs, seqs, hands = setup["jinputs"]
    jmodel = setup["jmodel"]
    ref_err, ref_n, ref_mean = jeval.eval_sequences_batched(
        jmodel, JTrackerConfig(), setup["jvars"], rigs, seqs,
        jeval.make_batched_state(jmodel, S), hands,
    )
    err, n_valid, mean = port_known
    assert err.shape == n_valid.shape == (S,) and mean.shape == ()
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(ref_n))
    assert (n_valid > 0).all()
    np.testing.assert_allclose(err.numpy(), np.asarray(ref_err), atol=MM_TOL)
    np.testing.assert_allclose(float(mean), float(ref_mean), rtol=MEAN_RTOL)
    # the global mean is the mean over the sequences with a valid slot
    np.testing.assert_allclose(float(mean), float(err.mean()), rtol=1e-6)


def test_batched_matches_per_sequence_tracking(setup):
    """One lock-step call over S sequences reproduces tracking each alone."""
    rigs, seqs, hands = setup["inputs"]
    model = setup["model"]
    batched, _ = track_sequences_batched(
        model, TrackerConfig(), rigs, seqs, peval.make_batched_state(model, S, "cpu"), hands,
        device="cpu",
    )
    tracker = HandTracker(model, device="cpu")
    for i in range(S):
        one, _ = tracker.track_sequence(
            rigs.map(lambda a: a[i]), seqs.map(lambda a: a[i]), hands.map(lambda a: a[i])
        )
        np.testing.assert_array_equal(batched.valid[:, i].numpy(), one.valid.numpy())
        np.testing.assert_allclose(
            batched.joint_angles[:, i].numpy(), one.joint_angles.numpy(), rtol=1e-4, atol=1e-4
        )


def test_unknown_protocol_matches_jax(setup):
    rigs, seqs, hands = setup["inputs"]
    jrigs, jseqs, jhands = setup["jinputs"]
    generic = from_dict(load_generic_hand_dict())
    per_seq, n_valid, mean, scales = peval.eval_sequences_unknown_batched(
        setup["model"], TrackerConfig(), rigs, seqs, hands, generic,
        n_calibration_samples=N_CALIBRATION, device="cpu",
    )
    ref_seq, ref_n, ref_mean, ref_scales = jeval.eval_sequences_unknown_batched(
        setup["jmodel"], JTrackerConfig(), setup["jvars"], jrigs, jseqs, jhands,
        jload_hand(GENERIC_HAND_JSON), n_calibration_samples=N_CALIBRATION,
    )
    assert per_seq.shape == scales.shape == (S,)
    np.testing.assert_allclose(scales.numpy(), np.asarray(ref_scales), atol=SCALE_TOL)
    np.testing.assert_array_equal(n_valid.numpy(), np.asarray(ref_n))
    np.testing.assert_allclose(per_seq.numpy(), np.asarray(ref_seq), atol=MM_TOL)
    np.testing.assert_allclose(float(mean), float(ref_mean), rtol=MEAN_RTOL)


def test_shard_eval_inputs_takes_contiguous_blocks(setup):
    rigs, seqs, hands = setup["inputs"]
    state = peval.make_batched_state(setup["model"], S, "cpu")
    state.valid_history[:] = torch.arange(2 * S) % 3 == 0  # rows tell apart
    r, s, st, h = peval.shard_eval_inputs(1, 2, rigs, seqs, state, hands)
    assert torch.equal(s.images, seqs.images[2:4]) and torch.equal(r.fx, rigs.fx[2:4])
    assert torch.equal(h.joint_rest_positions, hands.joint_rest_positions[2:4])
    assert torch.equal(st.valid_history, state.valid_history[4:8])  # rows 2i, 2i+1 of seq i
    assert st.temporal.mem_features.shape[0] == 4
    # the JAX signature: rank 3 of a (data 2, model 2) mesh is data index 1
    r2, s2, st2, h2 = peval.shard_eval_inputs(Mesh(data=2, rank=3, model=2), rigs, seqs, state, hands)
    assert torch.equal(s2.images, s.images) and torch.equal(st2.valid_history, st.valid_history)
    with pytest.raises(ValueError, match="do not split"):
        peval.shard_eval_inputs(0, 3, rigs, seqs, state, hands)


def test_mesh_and_mesh_config():
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
    x = torch.arange(12).reshape(6, 2)
    assert torch.equal(shard_batch(x, Mesh(data=3, rank=2)), x[4:6])
    # the model axis: 2 does not divide a world of 1 (JAX asserts
    # n % model_axis == 0), and auto picks 1 on an odd world
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(model_axis=2)
    assert make_mesh(model_axis=0).shape == {"data": 1, "model": 1}
    for axis in (0, 2):
        assert config.MeshConfig(model_axis=axis).model_axis == axis
    with pytest.raises(ValueError, match="process group of 1"):
        make_mesh(world=2)
    assert config.MeshConfig(rank=3, world_size=4).world_size == 4
