"""Port parity: ``from_flax_variables`` and the model pieces of
``umetrack_torch`` against the JAX model with the same weights, in f32 on
the CPU, at a small config."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from umetrack_tpu.models import init_model, make_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.models.procrustes import procrustes_align_quat as jquat
from umetrack_tpu.models.umetrack import FrameInputs as JFrame
from umetrack_tpu.models.umetrack import SkeletonInputs as JSkel
from umetrack_tpu.models.umetrack import TemporalState as JState
from umetrack_tpu.models.umetrack import UmeTrackNet as JNet
from umetrack_torch.models import (
    FrameInputs,
    ModelConfig,
    SkeletonInputs,
    TemporalState,
    UmeTrackNet,
    from_flax_variables,
)
from umetrack_torch.models import backbone, components
from umetrack_torch.models.procrustes import procrustes_align_quat, procrustes_align_svd
from umetrack_torch.ops import bn_act
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
RTOL = ATOL = 1e-4
B = 3


def _nchw(a):  # JAX NHWC -> port NCHW
    return np.moveaxis(np.asarray(a), -1, -3)


@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig(**SMALL)
    jmodel = make_model(jcfg)
    jvars = jax.jit(lambda key: init_model(key, jcfg)[1])(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars)
    # perturb the BN running stats (as tests/conftest.py:165-172 does) so
    # that normalisation is not the identity
    rng = np.random.default_rng(1)

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "mean" in name:
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return (1.0 + rng.random(a.shape)).astype(np.float32)

    variables["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    cfg = ModelConfig(**SMALL)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    model.eval()
    jvars = jax.tree_util.tree_map(jnp.asarray, variables)
    return jmodel, jvars, model


@pytest.fixture(scope="module")
def inputs():
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
    return dict(
        images=rng.random((B, 2, 96, 96), dtype=np.float32),
        intrinsics=k,
        extrinsics=extr,
        n_views=np.asarray([2, 1, 2], np.int32),
        hand_idx=np.asarray([0, 1, 1], np.int32),
        use_memory=np.asarray([True, False, True]),
        axes=rng.standard_normal((B, 22, 3)).astype(np.float32),
        rest=(rng.standard_normal((B, 22, 3)) * 0.05).astype(np.float32),
        mem=rng.standard_normal((B, 6, 6, 6)).astype(np.float32),  # NHWC
        prev=extr[:, 1].copy(),
    )


def _frames(x):
    names = ("images", "intrinsics", "extrinsics", "n_views", "hand_idx", "use_memory")
    return (
        JFrame(**{n: jnp.asarray(x[n]) for n in names}),
        FrameInputs(**{n: torch.from_numpy(np.asarray(x[n])) for n in names}),
    )


def _close(ours, ref):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_from_flax_variables_roundtrip(models):
    _, jvars, model = models
    sd = model.state_dict()
    w = jvars["params"]["backbone"]["stage1_block0"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        sd["backbone.stage1_block0.conv1.weight"].numpy(), np.transpose(np.asarray(w), (3, 2, 0, 1))
    )
    d = jvars["params"]["skeleton_encoder"]["linear"]["kernel"]
    np.testing.assert_array_equal(sd["skeleton_encoder.linear.weight"].numpy(), np.asarray(d).T)
    np.testing.assert_array_equal(
        sd["regressor_k.block1.bn2.running_var"].numpy(),
        np.asarray(jvars["batch_stats"]["regressor_k"]["block1"]["bn2"]["var"]),
    )
    with pytest.raises(ValueError):
        from_flax_variables(jax.tree_util.tree_map(np.asarray, jvars), ModelConfig())


def test_extract_features_matches_jax(models, inputs):
    jmodel, jvars, model = models
    jframe, frame = _frames(inputs)
    ref = jmodel.apply(jvars, jframe, method=JNet.extract_features)
    with torch.no_grad():
        _close(model.extract_features(frame), _nchw(ref))


def test_temporal_step_matches_jax(models, inputs):
    jmodel, jvars, model = models
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((B, 6, 6, 12)).astype(np.float32)
    xf = inputs["extrinsics"][:, 0] @ np.linalg.inv(inputs["prev"]).astype(np.float32)
    jf, jm = jmodel.apply(
        jvars, jnp.asarray(feats), jnp.asarray(xf), jnp.asarray(inputs["use_memory"]),
        jnp.asarray(inputs["mem"]), method=JNet.temporal_step,
    )
    with torch.no_grad():
        f, m = model.temporal_step(
            torch.from_numpy(_nchw(feats)), torch.from_numpy(xf),
            torch.from_numpy(inputs["use_memory"]), torch.from_numpy(_nchw(inputs["mem"])),
        )
    _close(f, _nchw(jf))
    _close(m, _nchw(jm))


def test_encode_skeleton_and_regress_known_match_jax(models, inputs):
    jmodel, jvars, model = models
    jskel = JSkel(jnp.asarray(inputs["axes"]), jnp.asarray(inputs["rest"]))
    skel = SkeletonInputs(torch.from_numpy(inputs["axes"]), torch.from_numpy(inputs["rest"]))
    jsf = jmodel.apply(jvars, jskel, method=JNet.encode_skeleton)
    rng = np.random.default_rng(4)
    fused = rng.standard_normal((B, 6, 6, 12)).astype(np.float32)
    jout = jmodel.apply(
        jvars, jnp.asarray(fused), jsf, jnp.asarray(inputs["hand_idx"]),
        jnp.asarray(inputs["extrinsics"][:, 0]), method=JNet.regress_known,
    )
    with torch.no_grad():
        sf = model.encode_skeleton(skel)
        out = model.regress_known(
            torch.from_numpy(_nchw(fused)), sf, torch.from_numpy(inputs["hand_idx"]),
            torch.from_numpy(inputs["extrinsics"][:, 0]),
        )
    _close(sf, _nchw(jsf))
    _close(out.joint_angles, jout.joint_angles)
    _close(out.wrist_xfs, jout.wrist_xfs)
    _close(out.landmark_uncertainty_sigmas, jout.landmark_uncertainty_sigmas)


def test_known_skeleton_matches_jax(models, inputs):
    jmodel, jvars, model = models
    jframe, frame = _frames(inputs)
    jstate = JState(jnp.asarray(inputs["mem"]), jnp.asarray(inputs["prev"]))
    state = TemporalState(torch.from_numpy(_nchw(inputs["mem"])), torch.from_numpy(inputs["prev"]))
    jskel = JSkel(jnp.asarray(inputs["axes"]), jnp.asarray(inputs["rest"]))
    skel = SkeletonInputs(torch.from_numpy(inputs["axes"]), torch.from_numpy(inputs["rest"]))
    jout, jnew = jmodel.apply(jvars, jframe, jskel, jstate, method=JNet.known_skeleton)
    with torch.no_grad():
        out, new = model.known_skeleton(frame, skel, state)
    _close(out.joint_angles, jout.joint_angles)
    _close(out.wrist_xfs, jout.wrist_xfs)
    _close(new.mem_features, _nchw(jnew.mem_features))
    _close(new.prev_extrinsics, jnew.prev_extrinsics)


@pytest.mark.parametrize("head", ["known", "unknown"])
def test_channels_last_forward_matches_nchw(models, inputs, head, monkeypatch):
    """The forward a card runs channels-last, forced on the CPU (the rule
    takes the CPU for a card): the backbone, the FTL, the fusion, the
    temporal cell and the heads on channels-last tensors; every one-pass
    site is handed x and its residual in one layout, as the kernel demands
    (the stem's, after its one-channel convolution, and the skeleton
    encoder's, which follows no convolution, stay NCHW); the
    memory carry leaves in the layout it came in; the outputs equal the NCHW
    forward's within the f32 tolerance."""
    _, _, model = models
    _, frame = _frames(inputs)
    state = TemporalState(torch.from_numpy(_nchw(inputs["mem"])).contiguous(),
                          torch.from_numpy(inputs["prev"]))
    skel = SkeletonInputs(torch.from_numpy(inputs["axes"]), torch.from_numpy(inputs["rest"]))

    def forward():
        with torch.no_grad():
            if head == "known":
                return model.known_skeleton(frame, skel, state)
            return model.predict_scale(frame, state)

    want, want_state = forward()
    rule = backbone.channels_last_rule
    monkeypatch.setattr(backbone, "channels_last_rule", lambda device, *rest: rule("cuda", *rest))
    layouts = []

    def planned(x, norm, conv_bias=None, residual=None, residual_norm=None, pool=False):
        layouts.append(bn_act._plan(x, residual, pool)[0])  # raises on a mix
        return bn_act.batch_norm_act(x, norm, conv_bias, residual, residual_norm, pool)

    monkeypatch.setattr(backbone, "batch_norm_act", planned)
    monkeypatch.setattr(components, "batch_norm_act", planned)
    before = bn_act.batch_norm_act.formats[bn_act.CHANNELS_LAST]
    got, got_state = forward()
    assert bn_act.batch_norm_act.formats[bn_act.CHANNELS_LAST] == before + 1
    nchw = 1 + int(head == "known")  # the stem's pass; the known head's skeleton encoder
    assert layouts.count(bn_act.NCHW) == nchw
    assert layouts.count(bn_act.CHANNELS_LAST) == len(layouts) - nchw > 0
    assert got_state.mem_features.is_contiguous()
    for name in ("joint_angles", "wrist_xfs", "landmark_uncertainty_sigmas", "skel_scales"):
        if getattr(want, name) is not None:
            _close(getattr(got, name), getattr(want, name).numpy())
    _close(got_state.mem_features, want_state.mem_features.numpy())


@pytest.mark.parametrize("shape, channels_last, copied", [
    ((2, 1, 5, 7), False, False),
    ((6, 4, 1, 1), False, False),
    ((2, 3, 5, 7), False, True),
    ((2, 3, 5, 7), True, False),
], ids=["one-channel image", "1x1 kernel", "nchw", "already channels-last"])
def test_as_channels_last(shape, channels_last, copied):
    """A one-channel image or a 1x1 kernel is restrided as a view, an NCHW
    tensor copied, a channels-last one given back on its own storage; all
    come back with channels-last strides and the same values."""
    t = torch.arange(float(np.prod(shape))).reshape(shape)
    if channels_last:
        t = t.contiguous(memory_format=torch.channels_last)
    out = backbone.as_channels_last(t)
    _, c, h, w = shape
    assert out.stride() == (h * w * c, 1, w * c, c)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, t)
    assert (out.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()) == copied


@pytest.mark.parametrize("bias", [True, False])
def test_conv_without_bias_on_the_cpu(bias):
    """On the CPU the convolution adds its own bias: ``without_bias`` gives
    the layer's output, bias included where it has one, and leaves None."""
    torch.manual_seed(0)
    conv = backbone.Conv(3, 4, 3, padding=1, bias=bias)
    x = torch.randn(2, 3, 6, 6)
    with torch.no_grad():
        y, left = conv.without_bias(x)
        want = torch.nn.functional.conv2d(x, conv.weight, conv.bias, padding=1)
    assert left is None
    assert torch.equal(y, conv(x).detach()) and torch.equal(y, want)


def test_procrustes_quat_matches_svd_oracle_and_jax():
    rng = np.random.default_rng(5)
    src = rng.standard_normal((64, 7, 3)).astype(np.float32) * 0.1
    rot = np.stack([np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(64)])
    rot *= np.sign(np.linalg.det(rot))[:, None, None]
    dst = src @ np.swapaxes(rot, -1, -2) + rng.uniform(-0.3, 0.3, (64, 1, 3))
    dst = (dst + rng.standard_normal(dst.shape) * 0.01).astype(np.float32)
    quat = procrustes_align_quat(torch.from_numpy(src), torch.from_numpy(dst))
    svd = procrustes_align_svd(torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_allclose(quat.numpy(), svd.numpy(), atol=1e-4)
    np.testing.assert_allclose(
        quat.numpy(), np.asarray(jquat(jnp.asarray(src), jnp.asarray(dst))), atol=1e-5
    )
