"""ResNet image backbone (NCHW), sized for 96x96 mono crops.

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
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from .config import ModelConfig

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's: running <- 0.9 * running + 0.1 * batch


class Conv(nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``, as flax's ``nn.Conv(
    dtype=...)`` does: the input, the f32 weight and the f32 bias are cast
    to it and the output is in it."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``, as flax's ``nn.Dense(
    dtype=...)`` does."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d), self.bias.to(d))


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode is flax's ``nn.BatchNorm(
    use_running_average=not train, momentum=0.9, epsilon=1e-5)``: the batch
    is normalised with its own mean and biased variance, and the running
    stats move to ``0.9 * old + 0.1 * batch`` with the BIASED variance.
    Eval mode is ``nn.BatchNorm2d``'s own.  Statistics, scale and bias are
    f32; the output is rounded once to ``compute_dtype``."""

    def __init__(self, num_features: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(num_features, eps=BN_EPS, momentum=1.0 - BN_MOMENTUM)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
        else:
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
                self._update_running_stats(mean, var)
            y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(self.compute_dtype)

    def _update_running_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1.0 - BN_MOMENTUM)
        self.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1.0 - BN_MOMENTUM)


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
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 2, 2)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.proj_conv(x)
