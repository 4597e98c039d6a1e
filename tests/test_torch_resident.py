"""Port parity of the device-resident trainer (``umetrack_torch.parallel.resident``)
against the JAX package, on the CPU at a small config: the same numpy
corpus in both, the same gathered windows, and the same training steps
without augmentation."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from umetrack_tpu.kinematics.hand import from_dict as jfrom_dict
from umetrack_tpu.models import init_model, make_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.parallel import resident as jres
from umetrack_tpu.parallel import train as jtrain
from umetrack_tpu.utils.synthetic import load_generic_hand_dict
from umetrack_torch.kinematics.hand import from_dict
from umetrack_torch.models import ModelConfig, UmeTrackNet, from_flax_variables
from umetrack_torch.parallel import optim, resident
from umetrack_torch.parallel.train import LossWeights, create_train_state
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
N, T, V = 3, 6, 2
WINDOW = 3
# The metrics of 3 steps from the same weights: 1e-5, but the scale head's
# loss after the first update is 5e-4 (measured 4.7e-5 and 1.0e-4 at the
# second and third steps: a small term of the few weights that Adam's
# sign-like first steps move differently in the two packages).
STEP_RTOL = 1e-5
SCALE_LOSS_RTOL = 5e-4


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q[..., :, 0] *= np.where(np.linalg.det(q) < 0, -1.0, 1.0)[:, None]
    return q


def _rigid(rng, shape, t_scale):
    m = np.tile(np.eye(4, dtype=np.float32), (*shape, 1, 1))
    n = int(np.prod(shape))
    m[..., :3, :3] = _rotations(rng, n).reshape(*shape, 3, 3)
    m[..., :3, 3] = rng.standard_normal((*shape, 3)) * t_scale
    return m


@pytest.fixture(scope="module")
def arrays():
    """A corpus in the layout of ``prepare_tracker_sequences`` (mm), with an
    invalid second view here and there and one invalid hand."""
    rng = np.random.default_rng(0)
    view_valid = np.ones((N, T, 2, V), bool)
    view_valid[..., 1] = rng.random((N, T, 2)) < 0.7
    hand_valid = np.ones((N, T, 2), bool)
    hand_valid[1, 3, 0] = False
    intr = np.tile(np.eye(3, dtype=np.float32), (N, T, 2, V, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = rng.uniform(150, 300, (N, T, 2, V))
    intr[..., 0, 2] = intr[..., 1, 2] = 47.5
    scales = rng.uniform(0.85, 1.15, N).astype(np.float32)
    hands = [jfrom_dict(load_generic_hand_dict()) for _ in range(N)]
    hand_b = jax.tree_util.tree_map(lambda *a: None if a[0] is None else np.stack(a), *hands)
    return dict(
        images=rng.random((N, T, 2, V, 96, 96), dtype=np.float32),
        intrinsics=intr,
        T_world_from_eye=_rigid(rng, (N, T, 2, V), 300.0),
        view_valid=view_valid,
        hand_valid=hand_valid,
        n_views=view_valid.sum(-1).astype(np.int32),
        angles=rng.uniform(-0.5, 0.5, (N, T, 2, 22)).astype(np.float32),
        wrists_mm=_rigid(rng, (N, T, 2), 50.0),
        hand_model_mm_batched=hand_b,
        scales=scales,
    )


@pytest.fixture(scope="module")
def corpora(arrays):
    jcorpus = jres.corpus_from_arrays(**arrays)
    hand = from_dict(load_generic_hand_dict()).map(lambda a: a.expand(N, *a.shape).numpy())
    corpus = resident.corpus_from_arrays(**{**arrays, "hand_model_mm_batched": hand}, device="cpu")
    return jcorpus, corpus


@pytest.fixture(scope="module")
def variables():
    jvars = jax.jit(lambda key: init_model(key, JModelConfig(**SMALL))[1])(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars)


def _port_model(variables):
    cfg = ModelConfig(**SMALL)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    return model


def test_gather_window_matches_jax(corpora):
    """Every field of a gathered window, images bit for bit through bf16."""
    jcorpus, corpus = corpora
    idx = [1, 0]
    jb = jres.gather_window(jcorpus, jnp.asarray(idx, jnp.int32), jnp.asarray(2, jnp.int32), WINDOW)
    b = resident.gather_window(corpus, torch.tensor(idx), 2, WINDOW)
    pairs = [
        (jb.frames.images, b.frames.images), (jb.frames.intrinsics, b.frames.intrinsics),
        (jb.frames.extrinsics, b.frames.extrinsics), (jb.frames.n_views, b.frames.n_views),
        (jb.frames.hand_idx, b.frames.hand_idx), (jb.frames.use_memory, b.frames.use_memory),
        (jb.gt_joint_angles, b.gt_joint_angles), (jb.gt_wrist_world, b.gt_wrist_world),
        (jb.gt_scales, b.gt_scales), (jb.valid, b.valid),
        (jb.skeleton.joint_rest_positions, b.skeleton.joint_rest_positions),
        (jb.hand.landmark_rest_positions, b.hand.landmark_rest_positions),
    ]
    for a, c in pairs:
        a = np.asarray(a)
        assert a.shape == tuple(c.shape)
        np.testing.assert_array_equal(a.astype(np.float32), c.numpy().astype(np.float32))
    assert not b.valid.all() and not b.frames.use_memory[:, 0].any()


def test_augmentation_stays_in_its_ranges(corpora):
    """A constant image becomes gain * 0.5 + offset plus noise of sigma at
    most 0.03 per row; the window is reversed for about half the
    sequences; the same generator state gives the same batch."""
    _, corpus = corpora
    flat = dataclasses.replace(corpus, images=torch.full_like(corpus.images, 0.5))
    idx = torch.tensor([0, 1, 2])
    g = torch.Generator().manual_seed(0)
    plain = resident.gather_window(flat, idx, 1, WINDOW)
    reversed_seen = set()
    for _ in range(8):
        b = resident.gather_window(flat, idx, 1, WINDOW, g)
        imgs = b.frames.images
        assert float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0
        rows = imgs.reshape(imgs.shape[0], -1)
        assert bool(((rows.mean(1) > 0.5 * 0.85 - 0.05 - 3e-3) & (rows.mean(1) < 0.5 * 1.15 + 0.05 + 3e-3)).all())
        assert float(rows.std(1).max()) < 0.03 + 3e-3
        for s in range(3):
            same = torch.equal(b.gt_joint_angles[2 * s], plain.gt_joint_angles[2 * s])
            flipped = torch.equal(b.gt_joint_angles[2 * s], plain.gt_joint_angles[2 * s].flip(0))
            assert same or flipped
            reversed_seen.add(flipped and not same)
    assert reversed_seen == {False, True}
    again = resident.gather_window(flat, idx, 1, WINDOW, torch.Generator().manual_seed(0))
    first = resident.gather_window(flat, idx, 1, WINDOW, torch.Generator().manual_seed(0))
    assert torch.equal(again.frames.images, first.frames.images)


def test_resident_train_steps_match_jax(corpora, variables):
    """Three steps without augmentation at a constant learning rate, the
    same sequences and windows: every metric of every step.  (The weights
    themselves are not compared: Adam moves each by about lr * sign(g), and
    the sign of a gradient that is zero up to rounding differs between the
    packages; tests/test_torch_train.py holds the optimizer on identical
    gradients.)"""
    jcorpus, corpus = corpora
    jcfg = JModelConfig(**SMALL)
    jmodel = make_model(jcfg)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-4, weight_decay=1e-5))
    ts = jtrain.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), tx)
    model = _port_model(variables)
    state = create_train_state(
        model, optim.ClippedAdamW(model.parameters(), 1e-4, 1e-5, max_grad_norm=1.0)
    )
    w = LossWeights()
    draws = [([0, 2], 0), ([1, 0], 3), ([2, 1], 1)]
    for i, (idx, t0) in enumerate(draws):
        ts, jm = jres.resident_train_step(
            jmodel, tx, ts, jcorpus, jnp.asarray(idx, jnp.int32), jnp.asarray(t0, jnp.int32),
            jtrain.LossWeights(), WINDOW,
        )
        m = resident.resident_train_step(state, corpus, torch.tensor(idx), t0, w, WINDOW)
        assert set(m) == set(jm)
        for key in jm:
            rtol = SCALE_LOSS_RTOL if key == "scale_loss" and i else STEP_RTOL
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=rtol, atol=1e-7, err_msg=key)


def test_resident_training_learns_and_diagnoses(corpora, variables):
    _, corpus = corpora
    model = _port_model(variables)
    state, hist = resident.run_resident_training(
        model, corpus, num_steps=8, seqs_per_batch=2, window=WINDOW, log_every=4, eval_every=8,
        learning_rate=1e-3, seed=3,
    )
    assert state.step == 8 and [h["step"] for h in hist] == [0, 4, 7]
    assert np.isfinite(hist[-1]["loss"]) and hist[-1]["loss"] < hist[0]["loss"]
    assert np.isfinite(hist[-1]["eval_mpjpe_mm"]) and np.isfinite(hist[-1]["eval_mpjpa_deg"])
    stats = {k: v.clone() for k, v in model.state_dict().items()}
    for bn_train in (False, True):
        d = resident.resident_diagnose(model, corpus, torch.tensor([0, 1]), 0, WINDOW, bn_train)
        assert set(d) == {"mpjpe_full_mm", "mpjpe_angles_only_mm", "mpjpe_wrist_only_mm",
                          "wrist_trans_mm", "wrist_rot_deg"}
        assert all(np.isfinite(v) for v in d.values())
    assert all(torch.equal(stats[k], v) for k, v in model.state_dict().items())


def test_build_resident_corpus_stacks_entries(arrays):
    """``build_resident_corpus`` over per-sequence entries equals the
    stacked-array path."""
    hand = from_dict(load_generic_hand_dict()).map(lambda a: a.numpy())
    keys = ("images", "intrinsics", "T_world_from_eye", "view_valid", "hand_valid", "n_views",
            "angles")
    entries = [dict({k: arrays[k][i] for k in keys}, wrists_mm=arrays["wrists_mm"][i],
                    hand_model_mm=hand, scale=float(arrays["scales"][i])) for i in range(N)]
    a = resident.build_resident_corpus(entries, device="cpu")
    b = resident.corpus_from_arrays(
        **{**arrays, "hand_model_mm_batched": hand.map(lambda x: np.stack([x] * N))}, device="cpu"
    )
    assert a.n_sequences == N and a.n_frames == T
    for x, y in zip(a.__dict__.values(), b.__dict__.values()):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
