"""The one-pass eval-mode BatchNorm (``ops/bn_act.py``) and the model's use
of it, on the CPU: the plain version against the module sequence it
replaces, every form and dtype bit for bit, on NCHW and on channels-last
inputs; a whole eval forward against the same network walked op by op;
train mode and forwards that need gradients keep the ops one by one; the
wrapper's checks and its plan of a launch in either layout; the rule that
makes the activations channels-last on a card.  The kernel itself runs only
on a card (``chip_smoke.py``'s ``[bn_act]`` lines)."""
import collections
import dataclasses
import itertools

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
CL = "_channels_last"  # a form's case on channels-last inputs
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


def _cl(t, cl):
    return t.contiguous(memory_format=torch.channels_last) if cl else t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", FORMS + tuple(f + CL for f in FORMS))
def test_plain_is_the_module_sequence(form, dtype):
    """The plain version is the module sequence on NCHW tensors, bit for bit;
    on channels-last inputs (the ``*_channels_last`` cases) it gives the
    same result, bit for bit, in the channels-last layout."""
    cl, form = form.endswith(CL), form.removesuffix(CL)
    d = DTYPES[dtype]
    norm = _norm(16, d, 1)
    kw = {}
    with torch.inference_mode():
        if form in ("stem_bias_pool", "fusion_bias"):
            stem = form == "stem_bias_pool"
            conv = _perturb(Conv(1 if stem else 24, 16, 3 if stem else 1, padding="same", bias=True,
                                 compute_dtype=d), 2)
            x = _randn((B, conv.in_channels, 14, 10), torch.float32, 3)
            # the card's convolution: cuDNN's, then its bias in a pass of its own
            x, bias = conv(x, with_bias=False), conv.bias
            assert x.dtype == d and bias.dtype == torch.float32
            want = F.relu(norm(x + bias.to(d)[:, None, None]))
            want = F.max_pool2d(want, 2, 2) if stem else want
            kw = dict(conv_bias=bias, pool=stem)
        else:
            x, r = _randn((B, 16, 6, 6), d, 3), _randn((B, 16, 6, 6), d, 4)
            if form == "bn_relu":
                want = F.relu(norm(x))
            elif form == "identity_residual":
                want, kw = F.relu(norm(x) + r), dict(residual=_cl(r, cl))
            else:
                rnorm = _norm(16, d, 5)
                want, kw = F.relu(norm(x) + rnorm(r)), dict(residual=_cl(r, cl), residual_norm=rnorm)
        x = _cl(x, cl)
        got = batch_norm_act_plain(x, norm, **kw)
    assert got.dtype == d
    assert torch.equal(got, want)
    assert bn_act.layout(got) == (bn_act.CHANNELS_LAST if cl else bn_act.NCHW)
    # on the CPU the wrapper is the plain version and launches nothing
    before = batch_norm_act.launches
    with torch.inference_mode():
        again = batch_norm_act(x, norm, **kw)
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
    """The kernel takes channels-last samples as well as NCHW ones, and
    refuses a mix of the two: a channels-last activation (whose convolutions
    stay channels-last) reaches the wrapper, which on the CPU runs the plain
    version in that layout (equal to the walk) and on a card plans it for the
    NHWC kernel; a residual in the other layout than x is refused where the
    kernel would be launched, rather than run op by op."""
    model, _ = _model("float32")
    block = getattr(model.backbone, model.backbone.blocks[0])
    x = _randn((2, block.conv1.in_channels, 12, 12), torch.float32, 5)
    nhwc = x.to(memory_format=torch.channels_last)
    assert not nhwc[0].is_contiguous()
    with torch.inference_mode():
        assert torch.equal(block(nhwc), _walk_block(block, nhwc))
        y = block.conv1(nhwc)
        assert not y[0].is_contiguous()
        assert bn_act._plan(y, None, False)[0] == bn_act.CHANNELS_LAST
        with pytest.raises(ValueError, match="device"):
            bn_act._launch(y, block.bn1, None, None, None, False)
        for a, b in ((y, block.conv1(x)), (block.conv1(x), y)):
            with pytest.raises(ValueError, match="mix of layouts"):
                bn_act._launch(a, block.bn2, None, b, None, False)


def _bad_calls():
    norm = _norm(4, torch.float32, 1)
    x = _randn((2, 4, 6, 6), torch.float32, 2)
    nhwc = x.to(memory_format=torch.channels_last)
    return {
        "float16": (lambda: batch_norm_act(x.half(), norm), TypeError),
        # the layout is the kernel's to refuse (the CPU's plain version takes any)
        "not_contiguous": (lambda: bn_act._launch(x.transpose(2, 3), norm, None, None, None, False),
                           ValueError),
        # a channels-last x with an NCHW residual, and the other way round
        "channels_last": (lambda: bn_act._launch(nhwc, norm, None, x, None, False), ValueError),
        "nchw_beside_channels_last": (lambda: bn_act._launch(x, norm, None, nhwc, None, False),
                                      ValueError),
        "channels_last_too_wide": (lambda: bn_act._launch(
            torch.zeros((1, 2049, 2, 2)).to(memory_format=torch.channels_last),
            _norm(2049, torch.float32, 1), None, None, None, False), ValueError),
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


# ---- a launch's plan in either layout -------------------------------------


def _plan_cases():
    """(x, residual, pool, layout, pixel strides of x and residual, vector)."""
    x = _randn((3, 16, 6, 6), torch.float32, 1)
    nhwc = x.contiguous(memory_format=torch.channels_last)
    wide = _randn((3, 40, 6, 6), torch.float32, 2).contiguous(memory_format=torch.channels_last)
    odd = _randn((3, 6, 5, 7), torch.bfloat16, 3).contiguous(memory_format=torch.channels_last)
    one = _randn((3, 1, 8, 8), torch.float32, 4)
    return {
        "nchw": (x, x, False, bn_act.NCHW, (16, 16), True),
        "nchw_channel_slice": (x, _randn((3, 40, 6, 6), torch.float32, 5)[:, 8:24], False,
                               bn_act.NCHW, (16, 16), True),
        "channels_last": (nhwc, nhwc, False, bn_act.CHANNELS_LAST, (16, 16), True),
        "channels_last_pool": (nhwc, None, True, bn_act.CHANNELS_LAST, (16, 16), True),
        # the scale head's residual: a slice of the temporal cell's channels
        "channels_last_channel_slice": (nhwc, wide[:, 8:24], False, bn_act.CHANNELS_LAST,
                                        (16, 40), True),
        "channels_last_misaligned_slice": (nhwc, wide[:, 9:25], False, bn_act.CHANNELS_LAST,
                                           (16, 40), False),
        "channels_last_odd_channels": (odd, odd, False, bn_act.CHANNELS_LAST, (6, 6), False),
        "channels_last_odd_pool": (odd, None, True, bn_act.CHANNELS_LAST, (6, 6), False),
        # one channel is both layouts; x's reads NCHW, and the residual may be either
        "one_channel": (one, one.as_strided(one.shape, (64, 1, 8, 1)), False, bn_act.NCHW,
                        (1, 1), True),
    }


@pytest.mark.parametrize("case", list(_plan_cases()))
def test_plan_takes_either_layout(case):
    """``_plan`` reads x's layout, takes a residual in that layout (a slice of
    channels too), gives the output x's layout and the kernel's strides, and
    takes 16-byte vectors only where channels, strides and pointers allow."""
    x, residual, pool, want, (x_pixel, r_pixel), vector = _plan_cases()[case]
    fmt, strides, got_vector, out = bn_act._plan(x, residual, pool)
    assert fmt == want and got_vector == vector
    n, c, h, w = x.shape
    assert out.shape == ((n, c, h // 2, w // 2) if pool else x.shape) and out.dtype == x.dtype
    assert bn_act.layout(out) == want
    if want == bn_act.CHANNELS_LAST:
        assert out.is_contiguous(memory_format=torch.channels_last)
        r_stride = (residual if residual is not None else x).stride(0)
        if residual is None:
            r_stride = c * h * w
        assert strides == (x.stride(0), x_pixel, r_stride, r_pixel)
    else:
        assert out.is_contiguous() and strides[0] == x.stride(0)


# ---- the rule that makes a card's activations channels-last -----------------


RULE_CASES = list(itertools.product(
    ("cuda", "cpu"), (True, False), ("bfloat16", "float32_tf32", "float32"), (None, "group")))


@pytest.mark.parametrize("device,one_pass,precision,group", RULE_CASES,
                         ids=["-".join(str(v) for v in case) for case in RULE_CASES])
def test_channels_last_rule(device, one_pass, precision, group):
    """Channels-last exactly on CUDA, in a one-pass forward, on tensor cores
    (bf16, or float32 with TF32), with no model group."""
    dtype = torch.bfloat16 if precision == "bfloat16" else torch.float32
    got = backbone.channels_last_rule(device, one_pass, dtype, precision == "float32_tf32", group)
    assert got == (device == "cuda" and one_pass and precision != "float32" and group is None)
    if precision == "bfloat16":  # bf16 runs on tensor cores whatever the TF32 switch
        assert got == backbone.channels_last_rule(device, one_pass, dtype, True, group)


def test_conv_reads_the_rule_from_what_it_observes(monkeypatch):
    """``Conv.channels_last`` hands the rule the input's device, whether the
    forward is a one-pass one (eval mode, nothing for autograd), the compute
    dtype, cuDNN's TF32 switch and the model group (the layer's own, else
    that of the sharded model it belongs to)."""
    seen = []

    def rule(*args):
        seen.append(args)
        return False

    monkeypatch.setattr(backbone, "channels_last_rule", rule)
    conv = Conv(8, 8, 3, padding=1, compute_dtype=torch.bfloat16).eval()
    x = _randn((2, 8, 6, 6), torch.float32, 1)
    with torch.no_grad():
        conv(x)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    conv(x)  # grad mode on, the weight requires grad
    conv.model_group = "group"  # (a sharded layer's forward gathers over its group)
    conv.train()
    with torch.no_grad():
        conv.channels_last(x)
        conv.model_group, conv.mesh_group = None, "mesh"  # an unsharded layer of a sharded model
        conv.channels_last(x)
    bf16 = torch.bfloat16
    assert seen == [("cpu", True, bf16, True, None), ("cpu", False, bf16, False, None),
                    ("cpu", False, bf16, False, "group"), ("cpu", False, bf16, False, "mesh")]


@pytest.mark.parametrize("forced", [False, True])
def test_backbone_counts_its_forwards_by_layout(forced, monkeypatch):
    """``batch_norm_act.formats`` counts a forward ``nchw`` on the CPU and
    ``channels_last`` where the rule holds (here forced by taking the CPU
    for a card), whose stages then run channels-last."""
    if forced:
        rule = backbone.channels_last_rule
        monkeypatch.setattr(backbone, "channels_last_rule", lambda device, *rest: rule("cuda", *rest))
    model, cfg = _model("float32")
    x = _randn((2, 1, 96, 96), torch.float32, 1)
    before = collections.Counter(batch_norm_act.formats)
    with torch.inference_mode():
        out = model.backbone(x)
    fmt = bn_act.CHANNELS_LAST if forced else bn_act.NCHW
    assert batch_norm_act.formats - before == {fmt: 1}
    assert bn_act.layout(out) == fmt
    with torch.no_grad():  # train mode: NCHW whatever the device
        model.train()
        model.backbone(x)
    assert batch_norm_act.formats - before == ({fmt: 1, bn_act.NCHW: 1} if forced else {fmt: 2})


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_conv_of_pixels_under_16_bytes_stays_nchw(dtype, monkeypatch):
    """Where the rule holds, a convolution whose input pixels fill 16 bytes
    takes channels-last input and weight; one whose pixels hold fewer (the
    stem's one channel; 4 bf16 channels) stays NCHW, as its forward and
    :meth:`Conv.input` agree.  Both equal the NCHW convolution."""
    rule = backbone.channels_last_rule
    monkeypatch.setattr(backbone, "channels_last_rule", lambda device, *rest: rule("cuda", *rest))
    d = DTYPES[dtype]
    for c_in in (1, 4, 8):
        conv = _perturb(Conv(c_in, 8, 3, padding=1, bias=True, compute_dtype=d), 1).eval()
        x = _randn((2, c_in, 10, 12), torch.float32, 2)
        cl = c_in * d.itemsize >= 16
        with torch.no_grad():
            assert conv.channels_last(x) and conv.takes_channels_last(x) == cl
            got = conv(x)
            want = F.conv2d(x.to(d), conv.weight.to(d), conv.bias.to(d), padding=1)
            assert bn_act.layout(conv.input(x)) == bn_act.layout(got)
        assert bn_act.layout(got) == (bn_act.CHANNELS_LAST if cl else bn_act.NCHW)
        torch.testing.assert_close(got, want, rtol=1e-5 if dtype == "float32" else 1e-2, atol=1e-5)
