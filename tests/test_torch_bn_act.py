"""The one-pass eval-mode BatchNorm (``ops/bn_act.py``) and the model's use
of it, on the CPU: the plain version against the module sequence it
replaces, every form and dtype bit for bit; a whole eval forward against
the same network walked op by op; train mode and forwards that need
gradients keep the ops one by one; the wrapper's checks.  The kernel itself
runs only on a card (``chip_smoke.py``'s ``[bn_act]`` lines)."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from umetrack_torch.models import FrameInputs, ModelConfig, SkeletonInputs, TemporalState, make_model
from umetrack_torch.models import backbone, components
from umetrack_torch.models.backbone import BasicBlock, BatchNorm, Conv, ResNetBackbone
from umetrack_torch.models.components import MultiViewFusion, SkeletonEncoder
from umetrack_torch.ops import bn_act
from umetrack_torch.ops.bn_act import batch_norm_act, batch_norm_act_plain
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

SMALL = dict(start_planes=8, backbone_blocks=(1, 2, 1, 1), n_image_feature_channels=12,
             n_memory_channels=6)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FORMS = ("bn_relu", "identity_residual", "bn_residual", "stem_bias_pool", "fusion_bias")
B = 3


def _perturb(module, seed):
    """Random BN statistics and affines (scales of both signs) and conv
    biases, so that no step is the identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
                m.running_var.copy_(0.5 + torch.rand(c, generator=g) * 1.5)
                m.weight.copy_(torch.randn(c, generator=g))
                m.bias.copy_(torch.randn(c, generator=g) * 0.3)
            elif isinstance(m, Conv) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.3)
    return module


def _norm(c, dtype, seed):
    return _perturb(BatchNorm(c, dtype), seed).eval()


def _randn(shape, dtype, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS)
def test_plain_is_the_module_sequence(form, dtype):
    d = DTYPES[dtype]
    norm = _norm(16, d, 1)
    with torch.inference_mode():
        if form in ("stem_bias_pool", "fusion_bias"):
            stem = form == "stem_bias_pool"
            conv = _perturb(Conv(1 if stem else 24, 16, 3 if stem else 1, padding="same", bias=True,
                                 compute_dtype=d), 2)
            x = _randn((B, conv.in_channels, 14, 10), torch.float32, 3)
            # the card's convolution: cuDNN's, then its bias in a pass of its own
            y, bias = conv(x, with_bias=False), conv.bias
            assert y.dtype == d and bias.dtype == torch.float32
            want = F.relu(norm(y + bias.to(d)[:, None, None]))
            want = F.max_pool2d(want, 2, 2) if stem else want
            got = batch_norm_act_plain(y, norm, conv_bias=bias, pool=stem)
        else:
            x, r = _randn((B, 16, 6, 6), d, 3), _randn((B, 16, 6, 6), d, 4)
            if form == "bn_relu":
                want, got = F.relu(norm(x)), batch_norm_act_plain(x, norm)
            elif form == "identity_residual":
                want, got = F.relu(norm(x) + r), batch_norm_act_plain(x, norm, residual=r)
            else:
                rnorm = _norm(16, d, 5)
                want = F.relu(norm(x) + rnorm(r))
                got = batch_norm_act_plain(x, norm, residual=r, residual_norm=rnorm)
    assert got.dtype == d
    assert torch.equal(got, want)
    # on the CPU the wrapper is the plain version and launches nothing
    before = batch_norm_act.launches
    with torch.inference_mode():
        if form in ("stem_bias_pool", "fusion_bias"):
            again = batch_norm_act(y, norm, conv_bias=bias, pool=stem)
        elif form == "bn_relu":
            again = batch_norm_act(x, norm)
        elif form == "identity_residual":
            again = batch_norm_act(x, norm, residual=r)
        else:
            again = batch_norm_act(x, norm, residual=r, residual_norm=rnorm)
    assert torch.equal(again, got)
    assert batch_norm_act.launches == before


# ---- the network walked op by op --------------------------------------------


def _walk_backbone(self, x):
    x = F.max_pool2d(F.relu(self.stem_bn(self.stem_conv(x))), 2, 2)
    for name in self.blocks:
        x = getattr(self, name)(x)
    return self.proj_conv(x)


def _walk_block(self, x):
    y = F.relu(self.bn1(self.conv1(x)))
    y = self.bn2(self.conv2(y))
    residual = self.downsample_bn(self.downsample_conv(x)) if self.use_downsample else x
    return F.relu(y + residual)


def _walk_fusion(self, x):
    for i in range(self.n_blocks):
        x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
    return self.conv_out(x)


def _walk_skeleton(self, axes, rest):
    feats = torch.cat([axes, rest], dim=-1).reshape(axes.shape[0], -1)
    return F.relu(self.bn(self.linear(feats).view(axes.shape[0], self.out_channels,
                                                  *self.feature_map_size)))


def _inputs(cfg):
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
    h, w = cfg.feature_map_size
    frame = FrameInputs(
        images=torch.from_numpy(rng.random((B, 2, 96, 96), dtype=np.float32)),
        intrinsics=torch.from_numpy(k), extrinsics=torch.from_numpy(extr),
        n_views=torch.tensor([2, 1, 2], dtype=torch.int32),
        hand_idx=torch.tensor([0, 1, 1], dtype=torch.int32),
        use_memory=torch.tensor([True, False, True]),
    )
    skel = SkeletonInputs(torch.from_numpy(rng.standard_normal((B, 22, 3)).astype(np.float32)),
                          torch.from_numpy((rng.standard_normal((B, 22, 3)) * 0.05).astype(np.float32)))
    state = TemporalState(
        torch.from_numpy(rng.standard_normal((B, cfg.n_memory_channels, h, w)).astype(np.float32))
        .to(cfg.torch_dtype),
        torch.from_numpy(extr[:, 1].copy()))
    return frame, skel, state


def _model(dtype):
    cfg = ModelConfig(compute_dtype=dtype, **SMALL)
    return _perturb(make_model(cfg, seed=3), 4), cfg


def _sites(cfg, scale_head=True):
    """The one-pass sites of a known_skeleton (and a predict_scale) forward:
    each extracts features (the stem, two per backbone BasicBlock, one per
    fusion block) and runs a regressor (two per BasicBlock); the known
    head encodes the skeleton (one)."""
    head = 1 + 2 * sum(cfg.backbone_blocks) + cfg.n_fusion_blocks + 2 * cfg.n_regression_blocks
    return (1 + head) + (head if scale_head else 0)


class _Spy:
    """Counts the model's calls of the one-pass wrapper."""

    def __init__(self, monkeypatch):
        self.calls = 0

        def counted(*args, **kwargs):
            self.calls += 1
            return batch_norm_act(*args, **kwargs)

        monkeypatch.setattr(backbone, "batch_norm_act", counted)
        monkeypatch.setattr(components, "batch_norm_act", counted)


def _forward(model, inputs):
    frame, skel, state = inputs
    known, new_state = model.known_skeleton(frame, skel, state)
    scale, _ = model.predict_scale(frame, state)
    return [known.joint_angles, known.wrist_xfs, known.landmark_uncertainty_sigmas,
            new_state.mem_features, scale.joint_angles, scale.skel_scales, scale.wrist_xfs]


@pytest.mark.parametrize("dtype", DTYPES)
def test_eval_forward_is_the_unfused_walk(dtype, monkeypatch):
    model, cfg = _model(dtype)
    inputs = _inputs(cfg)
    spy = _Spy(monkeypatch)
    with torch.inference_mode():
        fused = _forward(model, inputs)
    assert spy.calls == _sites(cfg)
    for cls, walk in ((ResNetBackbone, _walk_backbone), (BasicBlock, _walk_block),
                      (MultiViewFusion, _walk_fusion), (SkeletonEncoder, _walk_skeleton)):
        monkeypatch.setattr(cls, "forward", walk)
    spy.calls = 0
    with torch.inference_mode():
        walked = _forward(model, inputs)
    assert spy.calls == 0
    for got, want in zip(fused, walked):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["train_mode", "input_requires_grad", "params_require_grad"])
def test_gradients_keep_the_ops_one_by_one(case, monkeypatch):
    model, cfg = _model("float32")
    frame, skel, state = _inputs(cfg)
    if case == "train_mode":
        model.train()
    elif case == "input_requires_grad":  # frozen weights, a gradient for the images
        model.requires_grad_(False)
        frame = dataclasses.replace(frame, images=frame.images.clone().requires_grad_())
    spy = _Spy(monkeypatch)
    before = batch_norm_act.launches
    out, _ = model.known_skeleton(frame, skel, state)
    out.joint_angles.square().sum().backward()
    # with frozen weights the skeleton encoder's input needs no gradient
    assert spy.calls == int(case == "input_requires_grad")
    assert batch_norm_act.launches == before
    grads = ([frame.images.grad] if case == "input_requires_grad"
             else [p.grad for p in model.backbone.parameters()])
    assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads)
    assert any(bool((g != 0).any()) for g in grads)
    # the same model without gradients takes the one pass again
    model.eval()
    spy.calls = 0
    with torch.no_grad():
        model.known_skeleton(frame, skel, state)
    assert spy.calls == _sites(cfg, scale_head=False)


def test_a_channels_last_input_is_refused_by_the_kernel():
    """The kernel takes NCHW samples: a channels-last activation (whose
    convolutions stay channels-last) reaches the wrapper, which on the CPU
    runs the plain version in that layout (equal to the walk) and on a card
    refuses it where the kernel would be launched, rather than running the
    ops one by one."""
    model, _ = _model("float32")
    block = getattr(model.backbone, model.backbone.blocks[0])
    x = _randn((2, block.conv1.in_channels, 12, 12), torch.float32, 5)
    nhwc = x.to(memory_format=torch.channels_last)
    assert not nhwc[0].is_contiguous()
    with torch.inference_mode():
        assert torch.equal(block(nhwc), _walk_block(block, nhwc))
        y = block.conv1(nhwc)
        assert not y[0].is_contiguous()
        with pytest.raises(ValueError, match="samples are contiguous"):
            bn_act._launch(y, block.bn1, None, None, None, False)
        with pytest.raises(ValueError, match="samples are contiguous"):
            bn_act._launch(block.conv1(x), block.bn2, None, y, None, False)


def _bad_calls():
    norm = _norm(4, torch.float32, 1)
    x = _randn((2, 4, 6, 6), torch.float32, 2)
    return {
        "float16": (lambda: batch_norm_act(x.half(), norm), TypeError),
        # the layout is the kernel's to refuse (the CPU's plain version takes any)
        "not_contiguous": (lambda: bn_act._launch(x.transpose(2, 3), norm, None, None, None, False),
                           ValueError),
        "channels_last": (lambda: bn_act._launch(x.to(memory_format=torch.channels_last), norm,
                                                 None, None, None, False), ValueError),
        "not_nchw": (lambda: batch_norm_act(x[0], norm), ValueError),
        "pool_with_residual": (lambda: batch_norm_act(x, norm, residual=x, pool=True), ValueError),
        "residual_shape": (lambda: batch_norm_act(x, norm, residual=x[:1]), ValueError),
        "residual_dtype": (lambda: batch_norm_act(x, norm, residual=x.bfloat16()), ValueError),
        "residual_norm_alone": (lambda: batch_norm_act(x, norm, residual_norm=norm), ValueError),
        "norm_channels": (lambda: batch_norm_act(x, _norm(5, torch.float32, 1)), ValueError),
        "conv_bias_dtype": (lambda: batch_norm_act(x, norm, conv_bias=torch.zeros(4).double()),
                            ValueError),
        "pool_1_row": (lambda: batch_norm_act(x[:, :, :1].contiguous(), norm, pool=True), ValueError),
    }


@pytest.mark.parametrize("case", list(_bad_calls()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    call, error = _bad_calls()[case]
    with pytest.raises(error):
        call()


def test_cuda_launch_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="device"):
        bn_act._launch(_randn((1, 4, 4, 4), torch.float32, 0), _norm(4, torch.float32, 1),
                       None, None, None, False)
