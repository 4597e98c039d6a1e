"""ResNet image backbone, sized for 96x96 mono crops.

Counterpart of ``umetrack_tpu/models/backbone.py``: stem conv + BN + ReLU +
maxpool/2, four BasicBlock stages, then a 1x1 projection to the
image-feature channels.  Submodule names follow the flax tree
(``stem_conv``, ``stage0_block0.conv1``, ``proj_conv``, ...) so that
``models/convert.py`` maps the JAX weights by a plain walk.  Every
normalisation layer of the model is :class:`BatchNorm`, whose train mode
is flax's.

The compute dtype (``ModelConfig.compute_dtype``) follows flax layer by
layer with explicit casts, never ``torch.autocast`` (whose op lists differ
between CPU and CUDA, and which leaves BatchNorm's output in f32):
parameters and buffers stay f32; :class:`Conv` and :class:`Dense` cast
their input, weight and bias to the compute dtype and compute in it;
:class:`BatchNorm` normalises in f32 and rounds once to the compute dtype;
ReLU, max-pool and the residual add run in the compute dtype.

In eval mode, with nothing for autograd to record (:func:`one_pass`), each
BatchNorm and what follows it up to the next convolution (the residual
add, ReLU, the stem's max-pool, and on a CUDA device the preceding conv's
bias: :meth:`Conv.without_bias`) is one pass of ``ops/bn_act.py``, with the
same rounding; train mode and a forward that needs gradients run the ops
one by one.

Tensors are NCHW, and on a card the activations of an eval-mode forward
are channels-last (NHWC) where the convolutions run on tensor cores:
cuDNN's TF32 and bf16 kernels are NHWC, and an NCHW tensor would be
transposed in and out of each of them.  :func:`channels_last_rule` decides
it from what the forward can observe (CUDA, the one pass, bf16 or TF32, no
model group), each :class:`Conv` hands cuDNN its input and weight in that
layout (:meth:`Conv.input`), and what follows a convolution keeps its
layout (the one-pass kernel takes either); the stem's one-channel
convolution and its pass stay NCHW, and the first block takes their
output channels-last.  The CPU, train mode, float32 with TF32 off and the
tensor-parallel path stay NCHW.
``batch_norm_act.formats`` counts the backbone's forwards by layout.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F

from ..ops.bn_act import CHANNELS_LAST, NCHW, batch_norm_act
from .config import ModelConfig

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: running <- 0.9 * running + 0.1 * batch
FORMATS = batch_norm_act.formats  # the backbone's forwards by layout


def channels_last_rule(device_type: str, one_pass: bool, compute_dtype: torch.dtype,
                       allow_tf32: bool, model_group) -> bool:
    """Whether a convolution and the activations around it are channels-last:
    on a CUDA device, in a forward that runs the one pass (:func:`one_pass`:
    eval mode, nothing for autograd to record), where cuDNN runs it on
    tensor cores (bf16, or float32 with ``torch.backends.cudnn.allow_tf32``,
    part of a captured step's key), and not in a model sharded over a model
    group."""
    return (device_type == "cuda" and one_pass and model_group is None
            and (compute_dtype == torch.bfloat16
                 or (compute_dtype == torch.float32 and allow_tf32)))


def as_channels_last(t: torch.Tensor) -> torch.Tensor:
    """The 4-D ``t`` with channels-last strides: a copy where its elements lie
    in another order, else a view that gives the strides of size-one
    dimensions their channels-last values (a one-channel image or a 1x1
    kernel is contiguous both ways, and PyTorch reads its layout from its
    strides)."""
    if t.is_contiguous(memory_format=torch.channels_last):
        _, c, h, w = t.shape
        return t.as_strided(t.shape, (h * w * c, 1, w * c, c))
    return t.contiguous(memory_format=torch.channels_last)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``, as flax's ``nn.Conv(
    dtype=...)`` does: the input, the f32 weight and the f32 bias are cast
    to it (the weight stays an f32 ``Parameter``; its gradient reaches it
    through the cast) and the output is in it.  Where
    :func:`channels_last_rule` holds, the input and the cast weight are
    channels-last (:meth:`input`), and so is the output; the weight takes
    its layout inside the forward, so a captured step reads the parameter
    itself and sees it updated in place.  An input whose pixels hold fewer
    than 16 bytes (the stem's one channel) stays NCHW: no tensor-core
    kernel takes it, and for it cuDNN's NCHW kernel is the fastest (given
    channels-last it transposes around it).

    ``model_group`` is set by ``parallel/mesh.py::shard_variables`` when the
    weight is this rank's slice of the output channels: the layer then
    computes its slice and gathers the rest over the group, in the compute
    dtype (``parallel/collectives.py``).  ``mesh_group`` is the model group
    of the sharded model the layer belongs to, sharded or not (set on each
    of its ``Conv`` layers by the same call): the whole model stays NCHW."""

    model_group = None
    mesh_group = None

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def channels_last(self, x: torch.Tensor) -> bool:
        """:func:`channels_last_rule` for this layer on the input ``x``."""
        group = self.model_group if self.model_group is not None else self.mesh_group
        return channels_last_rule(x.device.type, not self.training and one_pass(x, self),
                                  self.compute_dtype, torch.backends.cudnn.allow_tf32, group)

    def takes_channels_last(self, x: torch.Tensor) -> bool:
        """Whether this layer computes channels-last on ``x``: where
        :meth:`channels_last` holds and a pixel of ``x`` fills 16 bytes in
        the compute dtype."""
        return x.shape[1] * self.compute_dtype.itemsize >= 16 and self.channels_last(x)

    def input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the layout this layer takes it in: channels-last where
        :meth:`takes_channels_last` (a copy unless it is already), else as
        it is."""
        return as_channels_last(x) if self.takes_channels_last(x) else x

    def forward(self, x: torch.Tensor, with_bias: bool = True) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None or not with_bias else self.bias.to(d)
        if self.model_group is None:
            if self.takes_channels_last(x):
                return self._conv_forward(as_channels_last(x.to(d)),
                                          as_channels_last(self.weight.to(d)), bias)
            return self._conv_forward(x.to(d), self.weight.to(d), bias)
        from ..parallel.collectives import copy_to_model, gather_from_model

        g = self.model_group
        y = gather_from_model(self._conv_forward(copy_to_model(x.to(d), g), self.weight.to(d), None), 1, g)
        return y if bias is None else y + bias[:, None, None]

    def without_bias(self, x: torch.Tensor):
        """(the convolution, the f32 bias it left for the next pass to add).
        On a CUDA device, where PyTorch adds a convolution's bias in a pass
        of its own after cuDNN's, the bias is left; on the CPU, whose
        convolutions add it inside their accumulation, and over a model
        group, which adds it after the gather, the convolution adds its own
        and leaves None."""
        if self.bias is None or self.model_group is not None or x.device.type != "cuda":
            return self(x), None
        return self(x, with_bias=False), self.bias


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``, as flax's ``nn.Dense(
    dtype=...)`` does; ``model_group`` as in :class:`Conv`."""

    model_group = None

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if self.model_group is None:
            return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))
        from ..parallel.collectives import copy_to_model, gather_from_model

        g = self.model_group
        return gather_from_model(F.linear(copy_to_model(x.to(d), g), self.weight.to(d)), -1, g) + self.bias.to(d)


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is flax's ``nn.BatchNorm(
    use_running_average=not train, momentum=0.9, epsilon=1e-5)``: the batch
    is normalised with its own mean and biased variance, and the running
    stats move to ``0.9 * old + 0.1 * batch`` with the BIASED variance
    (``nn.BatchNorm2d`` puts the unbiased one into ``running_var``).  Eval
    mode is ``nn.BatchNorm2d``'s own.

    Under a ``torch.distributed`` process group (of any size) train mode
    normalises with the statistics of the GLOBAL batch, as the JAX train
    step does over its mesh: see :meth:`_synchronised`.  ``data_group`` is
    the group it reduces over (None: the whole process group); on a mesh
    with a ``model`` axis ``parallel/mesh.py::shard_variables`` sets it to
    the data group, since the model ranks hold the same rows.

    The statistics, the scale and the bias are f32 whatever the input's
    dtype, and the normalisation runs in f32 (PyTorch's ``batch_norm``
    computes a bf16 input against f32 parameters in f32): the output is
    rounded once, to ``compute_dtype``, as flax's ``nn.BatchNorm(dtype=
    ...)`` rounds it.  In train mode the batch statistics are reduced in
    f32, as flax's ``force_float32_reductions`` does."""

    data_group = None

    def __init__(self, num_features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
        elif dist.is_available() and dist.is_initialized():
            y = self._synchronised(x)
        else:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
                self._update_running_stats(mean, var)
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(self.compute_dtype)

    def _update_running_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)

    def _synchronised(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the process group: per channel the count, sum and
        sum of squares of every rank's batch are summed by the
        differentiable ``all_reduce`` (its backward sums the ranks'
        gradients), giving the global mean and flax's biased variance
        ``E[x^2] - E[x]^2`` clipped at 0 (flax's ``use_fast_variance``).  The
        running stats move with those global moments, and the normalisation
        is written out, so the gradient flows through the reductions.
        ``nn.SyncBatchNorm`` is not used: it stores the unbiased variance."""
        from torch.distributed.nn.functional import all_reduce

        dims = (0, 2, 3)
        x = x.float()
        count = torch.full_like(self.running_mean, x.numel() // x.shape[1])
        moments = all_reduce(torch.stack([x.sum(dim=dims), (x * x).sum(dim=dims), count]),
                             group=self.data_group)
        mean = moments[0] / moments[2]
        var = torch.clamp(moments[1] / moments[2] - mean * mean, min=0.0)
        with torch.no_grad():
            self._update_running_stats(mean, var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]


def one_pass(x: torch.Tensor, *modules: nn.Module) -> bool:
    """Whether the BatchNorms in ``modules`` run as one pass with what
    follows them (``ops/bn_act.py``), given the input ``x`` of the first of
    ``modules``: none of them in train mode, nothing for autograd to record
    (grad mode off, or neither ``x`` nor a parameter of ``modules``
    requires grad).  The layout is the kernel's to check: on a CUDA device
    it takes NCHW or channels-last samples, a residual in x's."""
    if any(m.training for mod in modules for m in mod.modules() if isinstance(m, nn.BatchNorm2d)):
        return False
    return not torch.is_grad_enabled() or not (
        x.requires_grad or any(p.requires_grad for mod in modules for p in mod.parameters()))


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + residual (with 1x1 downsample) -> ReLU."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, padding=1, bias=False, compute_dtype=dtype)
        self.bn1 = BatchNorm(planes, dtype)
        self.conv2 = Conv(planes, planes, 3, 1, padding=1, bias=False, compute_dtype=dtype)
        self.bn2 = BatchNorm(planes, dtype)
        if use_downsample:
            self.downsample_conv = Conv(in_planes, planes, 1, stride, bias=False, compute_dtype=dtype)
            self.downsample_bn = BatchNorm(planes, dtype)
        self.use_downsample = use_downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if one_pass(x, self):
            x = self.conv1.input(x)  # the residual in the convolutions' layout
            y = self.conv2(batch_norm_act(self.conv1(x), self.bn1))
            if self.use_downsample:
                return batch_norm_act(y, self.bn2, residual=self.downsample_conv(x),
                                      residual_norm=self.downsample_bn)
            return batch_norm_act(y, self.bn2, residual=x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if self.use_downsample:
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNetBackbone(nn.Module):
    """Stem + stages + 1x1 projection; [N, 1, H, W] -> [N, C, H/16, W/16]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dtype = cfg.torch_dtype
        self.stem_conv = Conv(1, cfg.start_planes, 3, padding=1, bias=True, compute_dtype=dtype)
        self.stem_bn = BatchNorm(cfg.start_planes, dtype)
        self.blocks = []
        in_planes = cfg.start_planes
        for si, (n_blocks, stride) in enumerate(zip(cfg.backbone_blocks, cfg.backbone_strides)):
            planes = cfg.stage_out_planes[si]
            for bi in range(n_blocks):
                first = bi == 0
                name = f"stage{si}_block{bi}"
                self.add_module(name, BasicBlock(
                    in_planes, planes, stride=stride if first else 1,
                    use_downsample=first and (stride != 1 or cfg.stage_in_planes[si] != planes),
                    dtype=dtype,
                ))
                self.blocks.append(name)
                in_planes = planes
        self.proj_conv = Conv(in_planes, cfg.n_image_feature_channels, 1, bias=True,
                              compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        FORMATS[CHANNELS_LAST if self.stem_conv.channels_last(x) else NCHW] += 1
        if one_pass(x, self.stem_conv, self.stem_bn):
            y, bias = self.stem_conv.without_bias(x)
            x = batch_norm_act(y, self.stem_bn, conv_bias=bias, pool=True)
            del y  # the unpooled activation (4x the pooled one) is not kept through the stages
        else:
            x = F.max_pool2d(F.relu(self.stem_bn(self.stem_conv(x))), 2, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.proj_conv(x)
