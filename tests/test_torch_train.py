"""Port parity of the training step (``umetrack_torch.parallel.train`` and
``parallel.optim``) against the JAX package, in f32 on the CPU at a small
config: the same weights (carried across by ``from_flax_variables``), the
same numpy batch, and the JAX gradients and batch stats carried across by
the same converter, so the two are compared leaf by leaf."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from umetrack_tpu.kinematics.hand import from_dict as jfrom_dict
from umetrack_tpu.models import init_model, make_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.parallel import train as jtrain
from umetrack_tpu.utils.synthetic import load_generic_hand_dict
from umetrack_torch.kinematics.hand import HandModel, from_dict
from umetrack_torch.models import FrameInputs, ModelConfig, UmeTrackNet, from_flax_variables
from umetrack_torch.models.backbone import BatchNorm
from umetrack_torch.parallel import optim
from umetrack_torch.parallel.train import (
    LossWeights,
    TemporalTrainBatch,
    create_train_state,
    loss_fn,
    synthetic_train_batch,
    temporal_loss_fn,
    temporal_train_step,
    train_step,
)
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
B, K = 3, 4
LOSS_RTOL = 1e-5  # loss and metrics
GRAD_REL_L2 = 1e-3  # every gradient leaf: ||port - jax|| / ||jax||, but:
# the stem and the first block of the TBPTT window's gradient are summed over
# every pixel of K frames through train-mode BatchNorm's backward, whose
# mean-subtracting terms cancel in f32: there the two packages' gradients
# differ by more than 1e-3 on this test's window, as the f32 rounding of
# each goes, so they are held to 1e-2;
FIRST_LAYERS_REL_L2 = 1e-2
FIRST_LAYERS = ("backbone.stem_", "backbone.stage0_block0.")
# and the bias of a layer feeding a train-mode BatchNorm has a zero gradient
# in exact arithmetic (the mean is subtracted): both packages' gradients of it
# must be rounding noise, under 1e-5 of the whole gradient's norm.
ZERO_GRAD_LEAVES = ("backbone.stem_conv.bias", "fusion.conv0.bias", "fusion.conv1.bias")
ZERO_GRAD_NOISE = 1e-5
STATS_TOL = 1e-5  # BN running stats after the step (rtol and atol)
OPTIM_ATOL = 1e-7  # the optimizer against optax on the same gradients, on parameters
# of the size of the model's initial weights (|p| < 0.5, where an f32 ulp is
# at most 6e-8: the two order their roundings differently)
WEIGHTS = LossWeights(wrist_rot_gain=2.0, accel=100.0)


def _jweights(w):
    return jtrain.LossWeights(**{f: getattr(w, f) for f in w.__dataclass_fields__})


@pytest.fixture(scope="module")
def variables():
    jcfg = JModelConfig(**SMALL)
    jvars = jax.jit(lambda key: init_model(key, jcfg)[1])(jax.random.PRNGKey(0))
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars)
    rng = np.random.default_rng(1)

    def perturb(path, a):  # running stats that are not the identity
        if "mean" in jax.tree_util.keystr(path):
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return (1.0 + rng.random(a.shape)).astype(np.float32)

    out["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, out["batch_stats"])
    return out


@pytest.fixture
def port_model(variables):
    cfg = ModelConfig(**SMALL)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    return model


@pytest.fixture(scope="module")
def jmodel():
    return make_model(JModelConfig(**SMALL))


def _hands():
    d = load_generic_hand_dict()
    return jfrom_dict(d), from_dict(d)


def _frame_batches():
    """The same single-frame batch in both packages (numpy draws)."""
    jhand, hand = _hands()
    return jtrain.synthetic_train_batch(0, B, jhand), synthetic_train_batch(0, B, hand, device="cpu")


def _temporal_batches(valid=None):
    """A K-frame window in both packages from K single-frame draws: the
    rows keep their hand and skeleton, the crop cameras drift by 1 cm a
    frame, frame 0 has no memory."""
    jhand, hand = _hands()
    frames = [jtrain.synthetic_train_batch(10 + k, B, jhand) for k in range(K)]

    def stack(get):
        return np.stack([np.asarray(get(f)) for f in frames], axis=1)

    extr = np.repeat(np.asarray(frames[0].frame.extrinsics)[:, None], K, axis=1).copy()
    extr[..., :3, 3] += 0.01 * np.arange(K, dtype=np.float32)[None, :, None, None]
    arrays = dict(
        images=stack(lambda f: f.frame.images),
        intrinsics=np.repeat(np.asarray(frames[0].frame.intrinsics)[:, None], K, axis=1),
        extrinsics=extr,
        n_views=np.full((B, K), 2, np.int32),
        hand_idx=np.repeat(np.asarray(frames[0].frame.hand_idx)[:, None], K, axis=1),
        use_memory=np.broadcast_to(np.arange(K) > 0, (B, K)).copy(),
    )
    gt_angles = stack(lambda f: f.gt_joint_angles)
    gt_wrist = stack(lambda f: f.gt_wrist_world)
    scales = np.asarray(frames[0].gt_scales)
    jbatch = jtrain.TemporalTrainBatch(
        frames=jtrain.FrameInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        skeleton=frames[0].skeleton, gt_joint_angles=jnp.asarray(gt_angles),
        gt_wrist_world=jnp.asarray(gt_wrist), hand=frames[0].hand, gt_scales=jnp.asarray(scales),
        valid=None if valid is None else jnp.asarray(valid),
    )
    pframe = synthetic_train_batch(10, B, hand, device="cpu")
    batch = TemporalTrainBatch(
        frames=FrameInputs(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}),
        skeleton=pframe.skeleton, gt_joint_angles=torch.from_numpy(gt_angles),
        gt_wrist_world=torch.from_numpy(gt_wrist), hand=pframe.hand,
        gt_scales=torch.from_numpy(scales.copy()), valid=None if valid is None else torch.from_numpy(valid),
    )
    return jbatch, batch


def _jax_loss(jmodel, variables, jbatch, temporal):
    fn = jtrain.temporal_loss_fn if temporal else jtrain.loss_fn
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    (total, (new_stats, metrics)), grads = jax.value_and_grad(
        lambda p: fn(jmodel, p, stats, jbatch, _jweights(WEIGHTS)), has_aux=True
    )(params)
    to_np = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    return float(total), {k: float(v) for k, v in metrics.items()}, to_np(grads), to_np(new_stats)


def _compare(port_model, jmodel, variables, jbatch, batch, temporal):
    total_j, metrics_j, grads_j, stats_j = _jax_loss(jmodel, variables, jbatch, temporal)
    fn = temporal_loss_fn if temporal else loss_fn
    total, metrics = fn(port_model, batch, WEIGHTS)
    total.backward()

    np.testing.assert_allclose(float(total.detach()), total_j, rtol=LOSS_RTOL)
    assert set(metrics) == set(metrics_j)
    for key, value in metrics_j.items():
        np.testing.assert_allclose(float(metrics[key]), value, rtol=LOSS_RTOL, atol=1e-7, err_msg=key)

    want = from_flax_variables({"params": grads_j, "batch_stats": stats_j}, port_model.config)
    grads = dict(port_model.named_parameters())
    assert set(grads) == {k for k in want if "running" not in k and "num_batches" not in k}
    total_norm = np.sqrt(sum(np.sum(want[n].numpy().astype(np.float64) ** 2) for n in grads))
    for name, p in grads.items():
        g, gj = p.grad.numpy(), want[name].numpy()
        if name in ZERO_GRAD_LEAVES:
            assert max(np.linalg.norm(g), np.linalg.norm(gj)) <= ZERO_GRAD_NOISE * total_norm, name
            continue
        rel = np.linalg.norm(g - gj) / np.linalg.norm(gj)
        bound = FIRST_LAYERS_REL_L2 if name.startswith(FIRST_LAYERS) else GRAD_REL_L2
        assert rel <= bound, (name, rel, bound)
    for name, buf in port_model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=name)


def _regressor_u_stats(model):
    return {n: b.clone() for n, b in model.named_buffers() if n.startswith("regressor_u") and "running" in n}


def test_loss_fn_matches_jax(port_model, jmodel, variables):
    """Loss, metrics, every gradient leaf and the running stats after one
    single-frame pass; the scale head's own running-stat update is left
    out, as the JAX loss leaves it out."""
    jbatch, batch = _frame_batches()
    before = _regressor_u_stats(port_model)
    _compare(port_model, jmodel, variables, jbatch, batch, temporal=False)
    after = _regressor_u_stats(port_model)
    assert all(torch.equal(before[n], after[n]) for n in before)


def test_temporal_loss_fn_matches_jax(port_model, jmodel, variables):
    """The same over a K-frame TBPTT window (the accel term on): K
    running-stat updates of the known-skeleton pass, then the scale head's,
    which is kept."""
    valid = np.ones((B, K), bool)
    valid[1, 2] = False
    jbatch, batch = _temporal_batches(valid)
    before = _regressor_u_stats(port_model)
    _compare(port_model, jmodel, variables, jbatch, batch, temporal=True)
    after = _regressor_u_stats(port_model)
    assert not any(torch.equal(before[n], after[n]) for n in before)


def test_batch_norm_train_mode_is_flax():
    """Train mode normalises with the batch's biased variance and moves
    the running stats to 0.9 * old + 0.1 * batch (biased); eval mode is
    nn.BatchNorm2d's."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 4, 6, 6), generator=g) * 2.0 + 1.0
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
        bn.running_var.fill_(2.0)
    ref = torch.nn.BatchNorm2d(4, eps=1e-5).eval()
    ref.load_state_dict(bn.state_dict())
    assert torch.equal(bn.eval()(x), ref(x))
    y = bn.train()(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    want = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
    want = want * bn.weight[:, None, None] + bn.bias[:, None, None]
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(bn.running_var, 0.9 * 2.0 + 0.1 * var, rtol=1e-6, atol=1e-7)


def test_masked_rows_contribute_nothing(port_model):
    """A row masked out of the window does not change the loss, whatever
    its targets (the scale head's included)."""
    valid = np.ones((B, K), bool)
    valid[1] = False
    _, batch = _temporal_batches(valid)
    poisoned = TemporalTrainBatch(
        frames=batch.frames, skeleton=batch.skeleton,
        gt_joint_angles=batch.gt_joint_angles + torch.tensor([0.0, 100.0, 0.0])[:, None, None],
        gt_wrist_world=batch.gt_wrist_world.clone(), hand=batch.hand,
        gt_scales=batch.gt_scales * torch.tensor([1.0, 7.0, 1.0]), valid=batch.valid,
    )
    poisoned.gt_wrist_world[1, :, :3, 3] += 5.0
    state = {k: v.clone() for k, v in port_model.state_dict().items()}
    with torch.no_grad():
        loss_a = temporal_loss_fn(port_model, batch, WEIGHTS)[0]
        port_model.load_state_dict(state)
        loss_b = temporal_loss_fn(port_model, poisoned, WEIGHTS)[0]
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-6)


def test_train_steps_decrease_the_loss(port_model):
    """A few optimizer steps on one batch, single-frame then TBPTT."""
    _, batch = _frame_batches()
    _, tbatch = _temporal_batches()
    state = create_train_state(
        port_model, optim.ClippedAdamW(port_model.parameters(), 1e-3, 1e-5, max_grad_norm=1.0)
    )
    for step_fn, b in ((train_step, batch), (temporal_train_step, tbatch)):
        losses = [float(step_fn(state, b)["loss"]) for _ in range(4)]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 8 and state.optimizer.count == 8


def _tree(arrays):
    return {f"p{i}": a for i, a in enumerate(arrays)}


@pytest.mark.parametrize("clip_active", [False, True], ids=["clip_inactive", "clip_active"])
@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
def test_optimizer_matches_optax(clip_active, schedule):
    """Five updates from the same gradients: the port's clip + AdamW +
    schedule against optax's chain, parameter by parameter."""
    rng = np.random.default_rng(3)
    shapes = [(4, 3, 3, 3), (7,), (5, 6)]
    params = [rng.uniform(-0.25, 0.25, s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * (1.0 if clip_active else 0.02)
              for s in shapes] for _ in range(5)]
    if schedule == "constant":
        lr_j = lr = 1e-2
    else:
        lr_j = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-4)
        lr = optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-4)
        for count in range(8):
            np.testing.assert_allclose(lr(count), float(lr_j(count)), rtol=1e-12, atol=1e-15)
        assert lr(0) == 0.0
    chain = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(lr_j, weight_decay=0.05))
    jparams = _tree(jnp.asarray(p) for p in params)
    jstate = chain.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optim.ClippedAdamW(tparams, lr, weight_decay=0.05, max_grad_norm=1.0)
    for gs in grads:
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in gs))
        assert (norm >= 1.0) == clip_active
        updates, jstate = chain.update(_tree(jnp.asarray(g) for g in gs), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for i, p in enumerate(tparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[f"p{i}"]),
                                       rtol=0, atol=OPTIM_ATOL)


def test_synthetic_train_batch_matches_jax():
    jbatch, batch = _frame_batches()
    pairs = [
        (jbatch.frame.images, batch.frame.images), (jbatch.frame.intrinsics, batch.frame.intrinsics),
        (jbatch.frame.extrinsics, batch.frame.extrinsics), (jbatch.frame.hand_idx, batch.frame.hand_idx),
        (jbatch.gt_joint_angles, batch.gt_joint_angles), (jbatch.gt_wrist_world, batch.gt_wrist_world),
        (jbatch.gt_scales, batch.gt_scales), (jbatch.skeleton.joint_rest_positions,
                                              batch.skeleton.joint_rest_positions),
    ]
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.numpy().astype(np.float32))
    assert isinstance(batch.hand, HandModel) and batch.hand.joint_rotation_axes.shape == (B, 22, 3)
