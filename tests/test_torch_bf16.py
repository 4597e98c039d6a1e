"""The bfloat16 compute dtype of the port on the CPU.

- ``tests/test_bf16.py``'s check on the port: bf16 against f32 with the
  same weights at full width;
- port bf16 against JAX bf16, the same weights carried by
  ``from_flax_variables`` and the same numpy inputs: per module (the
  output's dtype is JAX's, the values agree within a few bf16 ulps of the
  reference's scale), for the two heads end to end (and every state leaf's
  dtype), and for the tracker;
- ``track_frame`` against ``track_sequence`` in bf16 at JAX's own bounds
  (``tests/test_tracker.py:269-270``);
- one bf16 training step against JAX's bf16 loss, and the same step in a
  one-rank gloo group against no group.

Small config (as ``tests/test_torch_model.py``) unless said otherwise.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

import synthetic
from umetrack_tpu.kinematics.hand import from_dict as jfrom_dict
from umetrack_tpu.models import init_model, make_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.models.umetrack import FrameInputs as JFrame
from umetrack_tpu.models.umetrack import SkeletonInputs as JSkel
from umetrack_tpu.models.umetrack import TemporalState as JState
from umetrack_tpu.models.umetrack import UmeTrackNet as JNet
from umetrack_tpu.parallel import train as jtrain
from umetrack_tpu.tracker import HandTracker as JHandTracker
from umetrack_tpu.utils.synthetic import load_generic_hand_dict
from umetrack_torch.kinematics.hand import from_dict
from umetrack_torch.models import (
    FrameInputs,
    ModelConfig,
    SkeletonInputs,
    TemporalState,
    UmeTrackNet,
    from_flax_variables,
)
from umetrack_torch.models import make_model as port_make_model
from umetrack_torch.parallel import distributed
from umetrack_torch.parallel.optim import ClippedAdamW
from umetrack_torch.parallel.train import (
    LossWeights,
    create_train_state,
    synthetic_train_batch,
    train_step,
)
from umetrack_torch.tracker import HandTracker
from umetrack_torch.utils.synthetic import our_sequence
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
B = 3
BF16 = "bfloat16"
# tests/test_bf16.py's bounds: bf16 against f32 through ~20 conv layers
F32_ANGLE_TOL, ORTHO_TOL = 0.08, 1e-3
# tests/test_tracker.py:269-270, bf16: track_frame against the hoisted scan
LOOP_ANGLE_TOL, LOOP_WRIST_TOL_MM = 2e-2, 2.0
# Port bf16 against JAX bf16, per module: both round every layer's output to
# bf16 but accumulate and order the f32 work inside a layer differently (and
# the port adds a conv's bias inside the convolution where flax adds it to
# the rounded output), so single roundings land one bf16 ulp apart and a
# few stack up through a module.  Measured on these inputs: 1.1-3.3 ulps of
# the reference's largest magnitude (an ulp being 2^-8 of it); held to 6.
ULP = 2.0 ** -8
MODULE_ULPS = 6
# ... end to end (one frame through each head, B=3): measured 3.9e-3 rad,
# 0.51 mm and equal scales; held to JAX's own bound for bf16 drift between
# its two tracker paths (2e-2 rad, 2 mm) and 1e-2 relative in scale.
E2E_ANGLE_TOL, E2E_WRIST_TOL_MM, E2E_SCALE_RTOL = 2e-2, 2.0, 1e-2
# ... and the tracker over a 7-frame sequence (the memory carried in bf16):
# measured 2.0e-3 rad and 0.40 mm, held to the same bounds.
T_FRAMES = 7
# One bf16 loss against JAX's bf16 loss on the same batch: measured 8.4e-5
# relative, held to 1e-3.
LOSS_RTOL = 1e-3
# A one-rank group against no group in bf16: the synchronised BatchNorm
# reduces sums where the local branch takes a two-pass variance, and in bf16
# a layer's output rounding can flip on that f32 difference.  Measured:
# metrics equal, running stats within 5.8e-8, gradient leaves within 6.1e-3
# relative L2, except the biases feeding a train-mode BatchNorm, whose
# gradient is zero in exact arithmetic and bf16 rounding noise here (9e-4 of
# the whole gradient's norm, where f32 keeps it under 1e-5).
GROUP_METRIC_RTOL, GROUP_STATS_TOL, GROUP_GRAD_REL_L2 = 1e-5, 1e-5, 2e-2
ZERO_GRAD_LEAVES = ("backbone.stem_conv.bias", "fusion.conv0.bias", "fusion.conv1.bias")
ZERO_GRAD_NOISE = 5e-3


def _nchw(a):  # JAX NHWC -> port NCHW
    return np.moveaxis(np.asarray(a, np.float32), -1, -3)


def _bf16_np(a):
    """``a`` rounded to bf16, as f32 numpy (both packages then read the
    same bf16 values)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def variables():
    """Flax variables of the small config with BN running stats that are not
    the identity and params moved off their start (flax's zero biases)."""
    jvars = jax.jit(lambda key: init_model(key, JModelConfig(**SMALL))[1])(jax.random.PRNGKey(0))
    out = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars)
    rng = np.random.default_rng(1)

    def perturb(path, a):
        if "mean" in jax.tree_util.keystr(path):
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return (1.0 + rng.random(a.shape)).astype(np.float32)

    out["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, out["batch_stats"])
    out["params"] = jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.05).astype(np.float32), out["params"]
    )
    return out


@pytest.fixture(scope="module")
def models(variables):
    """(JAX bf16 model, its variables, port bf16 model) with the same weights."""
    cfg = ModelConfig(**SMALL, compute_dtype=BF16)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return make_model(JModelConfig(**SMALL, compute_dtype=BF16)), jvars, model.eval()


def _module_close(name, ours, ref):
    """``ours`` has ``ref``'s dtype and lies within MODULE_ULPS bf16 ulps of
    ``ref``'s largest magnitude (feature maps compared in NCHW)."""
    assert str(ours.dtype).replace("torch.", "") == str(np.asarray(ref).dtype), name
    ref = np.asarray(ref, np.float32)
    if ref.ndim == 4:
        ref = np.moveaxis(ref, -1, -3)
    got = ours.detach().float().numpy()
    tol = MODULE_ULPS * ULP * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol, (name, np.abs(got - ref).max(), tol)


def test_bf16_forward_close_to_f32():
    """``tests/test_bf16.py`` on the port: the full-width model in bf16
    against the same weights in f32."""
    rng = np.random.default_rng(0)
    m32 = port_make_model(ModelConfig(), seed=0, device="cpu")
    m16 = UmeTrackNet(ModelConfig(compute_dtype=BF16))
    m16.load_state_dict(m32.state_dict())
    m16.eval()
    assert all(p.dtype == torch.float32 for p in m16.parameters())
    b = 2
    intr = np.tile(np.eye(3, dtype=np.float32), (b, 2, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = 200.0
    intr[..., 0, 2] = intr[..., 1, 2] = 47.5
    frame = FrameInputs(
        images=torch.from_numpy(rng.uniform(0, 1, (b, 2, 96, 96)).astype(np.float32)),
        intrinsics=torch.from_numpy(intr),
        extrinsics=torch.eye(4).expand(b, 2, 4, 4).contiguous(),
        n_views=torch.full((b,), 2, dtype=torch.int32),
        hand_idx=torch.tensor([0, 1], dtype=torch.int32),
        use_memory=torch.zeros((b,), dtype=torch.bool),
    )
    skel = SkeletonInputs(
        torch.from_numpy(rng.standard_normal((b, 22, 3)).astype(np.float32)),
        torch.from_numpy((rng.standard_normal((b, 22, 3)) * 0.05).astype(np.float32)),
    )
    with torch.no_grad():
        out32, _ = m32.known_skeleton(frame, skel, TemporalState.zeros(b, m32.config))
        out16, state16 = m16.known_skeleton(frame, skel, TemporalState.zeros(b, m16.config))
    assert out16.joint_angles.dtype == torch.float32  # decoded in f32
    assert state16.mem_features.dtype == torch.bfloat16
    assert torch.isfinite(out16.joint_angles).all() and torch.isfinite(out16.wrist_xfs).all()
    np.testing.assert_allclose(out16.joint_angles.numpy(), out32.joint_angles.numpy(), atol=F32_ANGLE_TOL)
    r = out16.wrist_xfs.numpy()[:, :3, :3]
    np.testing.assert_allclose(r @ r.transpose(0, 2, 1), np.tile(np.eye(3), (b, 1, 1)), atol=ORTHO_TOL)


MODULES = ["stem_stage0", "fusion", "temporal_step", "skeleton_encoder", "regressor"]


@pytest.mark.parametrize("name", MODULES)
def test_module_matches_jax_bf16(models, name):
    jmodel, jvars, model = models
    rng = np.random.default_rng(MODULES.index(name) + 10)
    with torch.no_grad():
        if name == "stem_stage0":
            img = rng.random((B * 2, 96, 96, 1), dtype=np.float32)
            _, inter = jmodel.apply(jvars, jnp.asarray(img), method=lambda m, x: m.backbone(x),
                                    capture_intermediates=True, mutable=["intermediates"])
            ref = inter["intermediates"]["backbone"]["stage0_block0"]["__call__"][0]
            bb = model.backbone
            x = F.relu(bb.stem_bn(bb.stem_conv(torch.from_numpy(_nchw(img)))))
            _module_close(name, bb.stage0_block0(F.max_pool2d(x, 2, 2)), ref)
        elif name == "fusion":
            # f32 input: the FTL hands the fusion f32 features
            x = rng.standard_normal((B, 6, 6, 24)).astype(np.float32)
            ref = jmodel.apply(jvars, jnp.asarray(x), method=lambda m, a: m.fusion(a))
            _module_close(name, model.fusion(torch.from_numpy(_nchw(x))), ref)
        elif name == "temporal_step":
            feats = rng.standard_normal((B, 6, 6, 12)).astype(np.float32)
            mem = _bf16_np(rng.standard_normal((B, 6, 6, 6)))
            q = np.linalg.qr(rng.standard_normal((B, 3, 3)))[0]
            xf = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
            xf[:, :3, :3] = q * np.sign(np.linalg.det(q))[:, None, None]
            xf[:, :3, 3] = rng.uniform(-0.05, 0.05, (B, 3))
            use = np.array([True, False, True])
            jf, jm = jmodel.apply(
                jvars, jnp.asarray(feats), jnp.asarray(xf), jnp.asarray(use),
                jnp.asarray(mem, jnp.bfloat16), method=JNet.temporal_step,
            )
            f, m = model.temporal_step(
                torch.from_numpy(_nchw(feats)), torch.from_numpy(xf), torch.from_numpy(use),
                torch.from_numpy(_nchw(mem)).to(torch.bfloat16),
            )
            _module_close("temporal fused", f, jf)
            _module_close("temporal memory", m, jm)
        elif name == "skeleton_encoder":
            axes = rng.standard_normal((B, 22, 3)).astype(np.float32)
            rest = (rng.standard_normal((B, 22, 3)) * 0.05).astype(np.float32)
            ref = jmodel.apply(jvars, JSkel(jnp.asarray(axes), jnp.asarray(rest)),
                               method=JNet.encode_skeleton)
            _module_close(name, model.encode_skeleton(
                SkeletonInputs(torch.from_numpy(axes), torch.from_numpy(rest))), ref)
        else:
            # the regressor's pooled features: the angles, the raw wrist points
            # and the sigmas are slices of them (softplus for the sigmas)
            fused = _bf16_np(rng.standard_normal((B, 6, 6, 12)))
            skel = _bf16_np(rng.standard_normal((B, 6, 6, 4)))
            hand = np.array([0, 1, 1], np.int32)
            extr = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
            jout = jmodel.apply(
                jvars, jnp.asarray(fused, jnp.bfloat16), jnp.asarray(skel, jnp.bfloat16),
                jnp.asarray(hand), jnp.asarray(extr), method=JNet.regress_known,
            )
            out = model.regress_known(
                torch.from_numpy(_nchw(fused)).to(torch.bfloat16),
                torch.from_numpy(_nchw(skel)).to(torch.bfloat16),
                torch.from_numpy(hand), torch.from_numpy(extr),
            )
            for field in ("joint_angles", "wrist_points", "landmark_uncertainty_sigmas"):
                _module_close(field, getattr(out, field), getattr(jout, field))


def _frame_inputs(rng):
    k = np.tile(np.eye(3, dtype=np.float32), (B, 2, 1, 1))
    k[..., 0, 0] = k[..., 1, 1] = rng.uniform(150, 250, (B, 2))
    k[..., 0, 2] = k[..., 1, 2] = 47.5
    extr = np.tile(np.eye(4, dtype=np.float32), (B, 2, 1, 1))
    for b in range(B):
        for v in range(2):
            q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
            extr[b, v, :3, :3] = q * np.sign(np.linalg.det(q))
    extr[..., :3, 3] = rng.uniform(-0.3, 0.3, (B, 2, 3))
    return dict(
        images=rng.random((B, 2, 96, 96), dtype=np.float32), intrinsics=k, extrinsics=extr,
        n_views=np.asarray([2, 1, 2], np.int32), hand_idx=np.asarray([0, 1, 1], np.int32),
        use_memory=np.asarray([True, False, True]),
    )


@pytest.mark.parametrize("head", ["known_skeleton", "predict_scale"])
def test_heads_match_jax_bf16(models, head):
    """One frame through a whole head: the outputs within the stated bounds,
    every output and state leaf in JAX's dtype (carry bf16,
    ``prev_extrinsics`` f32, decoded outputs f32)."""
    jmodel, jvars, model = models
    rng = np.random.default_rng(20)
    x = _frame_inputs(rng)
    mem = _bf16_np(rng.standard_normal((B, 6, 6, 6)))
    prev = x["extrinsics"][:, 1].copy()
    jframe = JFrame(**{n: jnp.asarray(v) for n, v in x.items()})
    frame = FrameInputs(**{n: torch.from_numpy(v) for n, v in x.items()})
    jstate = JState(jnp.asarray(mem, jnp.bfloat16), jnp.asarray(prev))
    state = TemporalState(torch.from_numpy(_nchw(mem)).to(torch.bfloat16), torch.from_numpy(prev))
    axes = rng.standard_normal((B, 22, 3)).astype(np.float32)
    rest = (rng.standard_normal((B, 22, 3)) * 0.05).astype(np.float32)
    with torch.no_grad():
        if head == "known_skeleton":
            jout, jnew = jmodel.apply(jvars, jframe, JSkel(jnp.asarray(axes), jnp.asarray(rest)), jstate,
                                      method=JNet.known_skeleton)
            out, new = model.known_skeleton(
                frame, SkeletonInputs(torch.from_numpy(axes), torch.from_numpy(rest)), state)
        else:
            jout, jnew = jmodel.apply(jvars, jframe, jstate, method=JNet.predict_scale)
            out, new = model.predict_scale(frame, state)
            assert out.skel_scales.dtype == torch.float32
            np.testing.assert_allclose(out.skel_scales.numpy(), np.asarray(jout.skel_scales),
                                       rtol=E2E_SCALE_RTOL)
    for field in ("joint_angles", "wrist_xfs", "landmark_uncertainty_sigmas", "wrist_points"):
        assert getattr(out, field).dtype == torch.float32, field
        assert getattr(jout, field).dtype == jnp.float32, field
    assert new.mem_features.dtype == torch.bfloat16 and jnew.mem_features.dtype == jnp.bfloat16
    assert new.prev_extrinsics.dtype == torch.float32 and jnew.prev_extrinsics.dtype == jnp.float32
    np.testing.assert_allclose(out.joint_angles.numpy(), np.asarray(jout.joint_angles), atol=E2E_ANGLE_TOL)
    np.testing.assert_allclose(out.wrist_xfs.numpy()[..., :3, 3] * 1e3,
                               np.asarray(jout.wrist_xfs)[..., :3, 3] * 1e3, atol=E2E_WRIST_TOL_MM)
    _module_close("new memory", new.mem_features, jnew.mem_features)
    np.testing.assert_array_equal(new.prev_extrinsics.numpy(), np.asarray(jnew.prev_extrinsics))


@pytest.fixture(scope="module")
def sequence(models, variables):
    labels, images = synthetic.make_labels_dict(T_FRAMES, rng_seed=13, render=False)
    jmodel, jvars, model = models
    return dict(
        jtracker=JHandTracker(jmodel, jvars),  # the JAX default on the CPU: gather1d
        jseq=synthetic.our_sequence(labels, images),
        tracker=HandTracker(model, device="cpu"),
        seq=our_sequence(labels, images, "cpu"),
    )


def _valid_gaps(angles, wrists, ref_angles, ref_wrists, valid):
    v = np.asarray(valid)
    assert v.any() and not v.all()
    da = np.abs(np.asarray(angles)[v] - np.asarray(ref_angles)[v]).max()
    dw = np.abs(np.asarray(wrists)[v][..., :3, 3] - np.asarray(ref_wrists)[v][..., :3, 3]).max()
    return da, dw


def test_track_frame_equals_track_sequence_bf16(sequence):
    """``tests/test_tracker.py``'s bf16 case on the port: the streaming
    carry (bf16 memory from step to step) against the hoisted scan."""
    tracker = sequence["tracker"]
    rig, seq, hand = sequence["seq"]
    ref, ref_state = tracker.track_sequence(rig, seq, hand)
    assert ref_state.temporal.mem_features.dtype == torch.bfloat16
    state, angles, wrists, valids = tracker.init_state(), [], [], []
    assert state.temporal.mem_features.dtype == torch.bfloat16
    for i in range(T_FRAMES):
        res, state = tracker.track_frame(rig, seq.map(lambda a: a[i]), state, hand)
        assert res.joint_angles.dtype == res.wrist_xfs.dtype == torch.float32
        angles.append(res.joint_angles)
        wrists.append(res.wrist_xfs)
        valids.append(res.valid)
    assert state.temporal.mem_features.dtype == torch.bfloat16
    assert state.temporal.prev_extrinsics.dtype == torch.float32
    np.testing.assert_array_equal(torch.stack(valids).numpy(), ref.valid.numpy())
    da, dw = _valid_gaps(torch.stack(angles), torch.stack(wrists), ref.joint_angles, ref.wrist_xfs,
                         ref.valid)
    assert da <= LOOP_ANGLE_TOL and dw <= LOOP_WRIST_TOL_MM, (da, dw)


def test_tracker_matches_jax_bf16(sequence):
    """The port's bf16 tracker against JAX's bf16 tracker on the same
    sequence and weights (both through their plain samplers)."""
    res, state = sequence["tracker"].track_sequence(*sequence["seq"])
    jres, jstate = sequence["jtracker"].track_sequence(*sequence["jseq"])
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(jres.valid))
    da, dw = _valid_gaps(res.joint_angles, res.wrist_xfs, jres.joint_angles, jres.wrist_xfs, res.valid)
    assert da <= E2E_ANGLE_TOL and dw <= E2E_WRIST_TOL_MM, (da, dw)
    assert state.temporal.mem_features.dtype == torch.bfloat16
    assert jstate.temporal.mem_features.dtype == jnp.bfloat16


def _train_batches():
    d = load_generic_hand_dict()
    return (jtrain.synthetic_train_batch(0, B, jfrom_dict(d)),
            synthetic_train_batch(0, B, from_dict(d), device="cpu"))


def _port_bf16_model(variables):
    cfg = ModelConfig(**SMALL, compute_dtype=BF16)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    return model


def test_train_step_bf16_matches_jax_loss(models, variables):
    """One bf16 step: the loss against JAX's bf16 loss on the same batch and
    weights; the parameters, their gradients and the BN running stats stay
    f32 and finite, and the step moves them."""
    jmodel, _, _ = models
    jbatch, batch = _train_batches()
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    jtotal, _ = jtrain.loss_fn(jmodel, params, stats, jbatch, jtrain.LossWeights())
    model = _port_bf16_model(variables)
    before = {n: t.clone() for n, t in model.state_dict().items()}
    state = create_train_state(model, ClippedAdamW(model.parameters(), 1e-3, 1e-5))
    metrics = train_step(state, batch, LossWeights())
    np.testing.assert_allclose(float(metrics["loss"]), float(jtotal), rtol=LOSS_RTOL)
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert torch.isfinite(p).all() and torch.isfinite(p.grad).all(), name
    for name, buf in model.named_buffers():
        if "running" in name:
            assert buf.dtype == torch.float32 and torch.isfinite(buf).all(), name
    moved = [n for n, t in model.state_dict().items() if not torch.equal(t, before[n])]
    assert "backbone.stem_conv.weight" in moved and "backbone.stem_bn.running_mean" in moved


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_train_step_bf16_in_a_one_rank_group(variables):
    """The same bf16 step inside a one-rank gloo group (the synchronised
    BatchNorm branch, gradients summed over the group) against no group."""
    def step():
        model = _port_bf16_model(variables)
        state = create_train_state(model, ClippedAdamW(model.parameters(), 1e-3, 1e-5))
        metrics = train_step(state, _train_batches()[1], LossWeights())
        return ({k: float(v) for k, v in metrics.items()},
                {n: p.grad.clone() for n, p in model.named_parameters()},
                {n: b.clone() for n, b in model.named_buffers() if "running" in n})

    m_a, g_a, s_a = step()
    assert distributed.initialize(f"localhost:{_free_port()}", 1, 0, device="cpu") == (0, 1)
    try:
        m_g, g_g, s_g = step()
    finally:
        distributed.finalize()
    assert not distributed.is_initialized()
    for key, want in m_a.items():
        assert abs(m_g[key] - want) <= GROUP_METRIC_RTOL * abs(want) + 1e-7, (key, m_g[key], want)
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g_a.values())))
    for name, want in g_a.items():
        assert torch.isfinite(g_g[name]).all(), name
        if name in ZERO_GRAD_LEAVES:
            assert max(float(g_g[name].norm()), float(want.norm())) <= ZERO_GRAD_NOISE * total, name
            continue
        rel = float((g_g[name] - want).norm() / want.norm())
        assert rel <= GROUP_GRAD_REL_L2, (name, rel)
    for name, want in s_a.items():
        assert s_g[name].dtype == torch.float32, name
        np.testing.assert_allclose(s_g[name].numpy(), want.numpy(), rtol=GROUP_STATS_TOL,
                                   atol=GROUP_STATS_TOL, err_msg=name)


def test_ftl_applies_an_f32_transform_to_bf16_features_in_f32():
    """An f32 transform applied to bf16 features returns f32, as JAX's
    promotion does, whole or in part (the untransformed channels upcast)."""
    from umetrack_tpu.models.ftl import apply_ftl as japply_ftl
    from umetrack_torch.models.ftl import apply_ftl

    rng = np.random.default_rng(30)
    feats = _bf16_np(rng.standard_normal((B, 6, 6, 12)))
    xf = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    xf[:, :3, 3] = rng.uniform(-1, 1, (B, 3))
    for ratio in (1.0, 0.5):
        ref = japply_ftl(jnp.asarray(xf), jnp.asarray(feats, jnp.bfloat16), ratio)
        out = apply_ftl(torch.from_numpy(xf), torch.from_numpy(_nchw(feats)).to(torch.bfloat16), ratio)
        assert ref.dtype == jnp.float32 and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), _nchw(ref), rtol=1e-6, atol=1e-6)


def test_torch_data_batch_matches_jax_bf16(variables):
    """The torch_data app's ``_run_batch`` in bf16 (its per-step state in
    bf16) against the JAX app's in bf16: per-sample errors (400-580 mm with
    these weights) within 1 mm, measured 0.26 mm (the f32 test holds 0.1)."""
    from umetrack_tpu.apps import run_inference_torch_data as japp
    from umetrack_torch.apps import run_inference_torch_data as app
    from umetrack_torch.utils.synthetic import make_torchdata_sample

    items = []
    for i in range(2):
        mono, labels = make_torchdata_sample(rng_seed=i, t=4, hand_idx=i % 2)
        items.append({"mono": mono, "labels": labels})
    jmodel = make_model(JModelConfig(**SMALL, compute_dtype=BF16))
    ours = app._run_batch(_port_bf16_model(variables).eval(), items, (96, 96), 2)
    ref = japp._run_batch(jmodel, jax.tree_util.tree_map(jnp.asarray, variables), items, (96, 96), 2)
    assert ours.shape == (2,) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1.0)


PATHS = ["track_sequences_batched", "calibrate_sequences_batched", "eval_sequences_batched",
         "eval_sequences_unknown_batched", "temporal_train_step", "run_resident_training",
         "train_app", "eval_app"]


@pytest.mark.parametrize("path", PATHS)
def test_path_runs_in_bf16(variables, path, tmp_path):
    """Every other entry point of the port with a bf16 model: it runs, its
    outputs are f32 and finite, its carry is bf16, and training leaves the
    parameters, gradients and running stats f32."""
    from umetrack_torch.kinematics.hand import load_generic_hand_dict as port_hand_dict
    from umetrack_torch.parallel import resident
    from umetrack_torch.parallel.eval import (
        eval_sequences_batched, eval_sequences_unknown_batched, make_batched_state)
    from umetrack_torch.parallel.train import TemporalTrainBatch, temporal_train_step
    from umetrack_torch.tracker.tracker import calibrate_sequences_batched, track_sequences_batched
    from umetrack_torch.utils.synthetic import make_sequences

    model = _port_bf16_model(variables).eval()
    tracker = HandTracker(model, device="cpu")
    trained = None
    if path in PATHS[:4]:
        s = 2
        rigs, seqs, hands = make_sequences(s, 3, seed=40, device="cpu")
        state = make_batched_state(model, s, "cpu")
        assert state.temporal.mem_features.dtype == torch.bfloat16
        if path == "track_sequences_batched":
            res, final = track_sequences_batched(model, tracker.config, rigs, seqs, state, hands, device="cpu")
            assert final.temporal.mem_features.dtype == torch.bfloat16
            outs = [res.joint_angles, res.wrist_xfs]
        elif path == "calibrate_sequences_batched":
            outs = [calibrate_sequences_batched(model, tracker.config, rigs, seqs, state, hands, device="cpu")]
        elif path == "eval_sequences_batched":
            outs = list(eval_sequences_batched(model, tracker.config, rigs, seqs, state, hands, device="cpu"))
        else:
            generic = from_dict(port_hand_dict())
            outs = list(eval_sequences_unknown_batched(model, tracker.config, rigs, seqs, hands, generic,
                                                       device="cpu"))
        for out in outs:
            assert out.dtype == torch.float32 and torch.isfinite(out).all(), path
    elif path == "temporal_train_step":
        hand = from_dict(load_generic_hand_dict())
        frames = [synthetic_train_batch(50 + k, B, hand, device="cpu") for k in range(3)]
        window = TemporalTrainBatch(
            frames=FrameInputs(**{
                f: torch.stack([getattr(b.frame, f) for b in frames], dim=1)
                for f in FrameInputs.__dataclass_fields__}),
            skeleton=frames[0].skeleton,
            gt_joint_angles=torch.stack([b.gt_joint_angles for b in frames], dim=1),
            gt_wrist_world=torch.stack([b.gt_wrist_world for b in frames], dim=1),
            hand=frames[0].hand, gt_scales=frames[0].gt_scales,
        )
        window.frames.use_memory[:, 1:] = True
        state = create_train_state(model, ClippedAdamW(model.parameters(), 1e-3, 1e-5))
        metrics = temporal_train_step(state, window, LossWeights(accel=100.0))
        assert all(np.isfinite(float(v)) for v in metrics.values())
        trained = model
    elif path == "run_resident_training":
        rng = np.random.default_rng(41)
        n, t, v = 2, 4, 2
        q = np.linalg.qr(rng.standard_normal((n * t * 2 * v, 3, 3)))[0]
        t_wfe = np.tile(np.eye(4, dtype=np.float32), (n * t * 2 * v, 1, 1))
        t_wfe[:, :3, :3] = q
        t_wfe[:, :3, 3] = rng.standard_normal((n * t * 2 * v, 3)) * 300.0
        wrists = np.tile(np.eye(4, dtype=np.float32), (n, t, 2, 1, 1))
        wrists[..., :3, 3] = rng.standard_normal((n, t, 2, 3)) * 50.0
        intr = np.tile(np.eye(3, dtype=np.float32), (n, t, 2, v, 1, 1))
        intr[..., 0, 0] = intr[..., 1, 1] = 200.0
        intr[..., 0, 2] = intr[..., 1, 2] = 47.5
        hand = from_dict(port_hand_dict()).map(lambda a: a.expand(n, *a.shape).numpy())
        corpus = resident.corpus_from_arrays(
            images=rng.random((n, t, 2, v, 96, 96), dtype=np.float32), intrinsics=intr,
            T_world_from_eye=t_wfe.reshape(n, t, 2, v, 4, 4), view_valid=np.ones((n, t, 2, v), bool),
            hand_valid=np.ones((n, t, 2), bool), n_views=np.full((n, t, 2), v, np.int32),
            angles=rng.uniform(-0.5, 0.5, (n, t, 2, 22)).astype(np.float32), wrists_mm=wrists,
            hand_model_mm_batched=hand, scales=np.ones(n, np.float32), device="cpu",
        )
        _, hist = resident.run_resident_training(
            model, corpus, num_steps=2, seqs_per_batch=2, window=3, log_every=1, eval_every=1)
        assert len(hist) == 2 and all(np.isfinite(h["loss"]) and np.isfinite(h["eval_mpjpe_mm"])
                                      for h in hist)
        trained = model
    elif path == "train_app":
        from umetrack_torch import config
        from umetrack_torch.apps import train as train_app

        cfg_path = tmp_path / "bf16.json"
        config.to_json(config.Config(model=ModelConfig(**SMALL, compute_dtype=BF16)), str(cfg_path))
        state, history = train_app.main(["--config", str(cfg_path), "--synthetic", "--steps", "2",
                                         "--batch-size", "2", "--window", "2", "--device", "cpu"])
        assert state.model.config.compute_dtype == BF16 and all(np.isfinite(history))
        trained = state.model
    else:
        from umetrack_torch.apps import run_eval_known_skeleton, run_eval_unknown_skeleton

        parser = run_eval_known_skeleton.argparse.ArgumentParser()
        run_eval_known_skeleton.add_eval_flags(parser)
        args = parser.parse_args(["--output-dir", str(tmp_path), "--device", "cpu", "--dtype", BF16])
        app_tracker = run_eval_unknown_skeleton.make_tracker(args)
        assert app_tracker.model.config.compute_dtype == BF16
        assert all(p.dtype == torch.float32 for p in app_tracker.model.parameters())
        rig, seq, hand = (tr.map(lambda a: a[0]) for tr in make_sequences(1, 2, seed=42, device="cpu"))
        res, final = app_tracker.track_sequence(rig, seq, hand)
        assert res.joint_angles.dtype == torch.float32 and torch.isfinite(res.joint_angles).all()
        assert final.temporal.mem_features.dtype == torch.bfloat16
    if trained is not None:
        for name, p in trained.named_parameters():
            assert p.dtype == torch.float32 and torch.isfinite(p).all(), name
            assert p.grad is None or (p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()), name
        for name, buf in trained.named_buffers():
            if "running" in name:
                assert buf.dtype == torch.float32 and torch.isfinite(buf).all(), name


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batch_norm_normalises_bf16_in_f32_and_rounds_once(train):
    """``BatchNorm`` with a bf16 input and the bf16 compute dtype equals
    flax's rule written out: normalise ``x.float()`` with f32 statistics,
    scale and bias, then round once to bf16 (within half a bf16 ulp of the
    value); in train mode the batch statistics are those of ``x.float()``
    and the running stats stay f32."""
    from umetrack_torch.models.backbone import BatchNorm

    g = torch.Generator().manual_seed(3)
    x = (torch.randn((4, 8, 6, 6), generator=g) * 3.0 + 1.0).to(torch.bfloat16)
    bn = BatchNorm(8, torch.bfloat16)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.uniform_(-0.5, 0.5, generator=g)
        bn.running_mean.normal_(0.0, 0.1, generator=g)
        bn.running_var.uniform_(1.0, 2.0, generator=g)
    mean0, var0 = bn.running_mean.clone(), bn.running_var.clone()
    y = bn.train(train)(x)
    xf = x.float()
    if train:
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        torch.testing.assert_close(bn.running_mean, 0.9 * mean0 + 0.1 * mean, rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(bn.running_var, 0.9 * var0 + 0.1 * var, rtol=1e-6, atol=1e-7)
    else:
        mean, var = mean0, var0
    want = ((xf - mean[:, None, None]) * (torch.rsqrt(var + 1e-5) * bn.weight)[:, None, None]
            + bn.bias[:, None, None])
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32
    ulp = torch.exp2(torch.floor(torch.log2(want.abs())) - 7)  # of the bf16 value
    assert ((y.float() - want).abs() <= 0.5 * ulp + 1e-6).all()
