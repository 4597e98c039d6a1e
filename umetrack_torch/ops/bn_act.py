"""Eval-mode BatchNorm with what follows it up to the next convolution, in
one pass: the hand-written CUDA kernel and its wrapper.

    out = ReLU(BN(x [+ conv_bias]) [+ residual | + BN_r(residual)])   [then max-pool 2x2/2]

Replaces no TPU kernel: XLA fused these ops on the TPU, and PyTorch runs
each as its own pass over the activation.  The pass is bounded by bytes; the
kernel (``csrc/bn_act.cu``, built at first use and loaded with ``ctypes``
by ``ops/_build.py``) reads each operand once and writes the result once,
computing BN's scale and shift from the running statistics in f32 itself
(no folded weights, no extra launch), and the pool form stores only the
pooled quarter.

The kernel takes either of the model's layouts (:func:`layout`): NCHW
samples, or channels-last (NHWC) samples, which ``models/backbone.py``
runs on the card where its convolutions run on tensor cores; its output
has the input's layout.

:func:`batch_norm_act` launches the kernel for CUDA tensors and runs the
plain version (:func:`batch_norm_act_plain`, the op sequence the model ran
before the kernel) for CPU tensors; ``batch_norm_act.launches`` counts
kernel launches and ``batch_norm_act.paths`` counts them by the kernel's
form and layout (``vector/nchw``, ``scalar/channels_last``, ...: ``vector``
16 bytes a thread, ``scalar`` one element), both where the kernel is
launched; ``batch_norm_act.formats`` counts the model's forwards by the
layout of their activations (``channels_last`` / ``nchw``, counted by
``models/backbone.py``).  A CUDA graph that captured launches or forwards
adds them on each replay (``tracker/compiled.py``).
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from . import _build

NAME = "bn_act"
_P = ctypes.c_void_p
_SIGNATURES = {
    "bn_act_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P, _P, _P, _P, ctypes.c_float,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P,
    ),
}
_DTYPES = (torch.float32, torch.bfloat16)
_LIMIT = 2**31 - 1  # threads of one launch, elements of one sample
_MAX_NHWC_CHANNELS = 2048  # csrc/bn_act.cu's kMaxChannels: the constants fill shared memory
NCHW, CHANNELS_LAST = "nchw", "channels_last"


@functools.lru_cache(maxsize=None)
def _library():
    return _build.library(NAME, _SIGNATURES)


def _eval_batch_norm(x: torch.Tensor, norm: nn.BatchNorm2d) -> torch.Tensor:
    """``models/backbone.py::BatchNorm``'s eval mode: the running statistics'
    normalisation, computed in f32 and rounded once to ``x``'s dtype."""
    y = F.batch_norm(x, norm.running_mean, norm.running_var, norm.weight, norm.bias,
                     False, 0.0, norm.eps)
    return y.to(x.dtype)


def batch_norm_act_plain(
    x: torch.Tensor,
    norm: nn.BatchNorm2d,
    conv_bias: Optional[torch.Tensor] = None,
    residual: Optional[torch.Tensor] = None,
    residual_norm: Optional[nn.BatchNorm2d] = None,
    pool: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`batch_norm_act`: the conv bias
    added in ``x``'s dtype (as cuDNN's convolutions leave it to a separate
    add), eval-mode BN, the residual (BN'd by ``residual_norm`` if given)
    added in ``x``'s dtype, ReLU, then ``F.max_pool2d(2, 2)`` if ``pool``."""
    if conv_bias is not None:
        x = x + conv_bias.to(x.dtype)[:, None, None]
    y = _eval_batch_norm(x, norm)
    if residual is not None:
        y = y + (residual if residual_norm is None else _eval_batch_norm(residual, residual_norm))
    y = F.relu(y)
    return F.max_pool2d(y, 2, 2) if pool else y


def _check_vector(t: torch.Tensor, n: int, what: str, device: torch.device) -> None:
    if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what} must be a contiguous float32 [{n}] tensor on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_norm(norm: nn.BatchNorm2d, c: int, device: torch.device, what: str) -> None:
    if norm.running_mean is None or norm.weight is None:
        raise ValueError(f"{what} needs running statistics and an affine weight and bias")
    for name in ("running_mean", "running_var", "weight", "bias"):
        _check_vector(getattr(norm, name), c, f"{what}.{name}", device)


def _samples_contiguous(t: torch.Tensor) -> bool:
    """Whether each sample of the NCHW tensor ``t`` is a contiguous [C, H, W]
    block (the whole tensor, or a slice of its channels, is)."""
    return t.shape[0] == 0 or t[0].is_contiguous()


def _pixel_stride(t: torch.Tensor) -> Optional[int]:
    """The elements from one pixel of ``t`` to the next where its samples are
    channels-last: each pixel's C channels adjacent, the pixels evenly spaced
    in row-major order (the whole channels-last tensor, or a slice of its
    channels, is); else None."""
    _, c, h, w = t.shape
    if c > 1 and t.stride(1) != 1:
        return None
    p = t.stride(3) if w > 1 else t.stride(2) if h > 1 else c
    if h > 1 and w > 1 and t.stride(2) != w * p:
        return None
    return p if p >= c else None


def layout(t: torch.Tensor) -> Optional[str]:
    """The layout of the 4-D tensor ``t``'s samples as the kernel reads them:
    ``"nchw"`` where each sample is a contiguous [C, H, W] block,
    ``"channels_last"`` where its pixels are (:func:`_pixel_stride`), else
    None.  A tensor that is both (one channel, or planes of one pixel) is
    ``"nchw"``."""
    if _samples_contiguous(t):
        return NCHW
    return CHANNELS_LAST if _pixel_stride(t) is not None else None


def _check(x, norm, conv_bias, residual, residual_norm, pool) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be NCHW, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    c, device = x.shape[1], x.device
    _check_norm(norm, c, device, "norm")
    if conv_bias is not None:
        _check_vector(conv_bias, c, "conv_bias", device)
    if residual is None:
        if residual_norm is not None:
            raise ValueError("residual_norm without a residual")
    else:
        if pool:
            raise ValueError("the pool form takes no residual")
        if residual.shape != x.shape or residual.dtype != x.dtype or residual.device != device:
            raise ValueError(f"residual must match x ({tuple(x.shape)} {x.dtype} on {device}), got "
                             f"{tuple(residual.shape)} {residual.dtype} on {residual.device}")
        if residual_norm is not None:
            _check_norm(residual_norm, c, device, "residual_norm")
    if pool and (x.shape[2] < 2 or x.shape[3] < 2):
        raise ValueError(f"the pool form needs planes of at least 2 x 2, got {tuple(x.shape[2:])}")


def _plan(x, residual, pool):
    """(layout, strides, vector, out) of a launch on checked tensors: the
    layout of ``x``'s samples, which the residual must share (a mix is
    refused); the elements from one sample of x, one pixel of x, one sample
    of the residual and one pixel of the residual to the next; whether
    16-byte vectors fit the shape, the strides and every pointer; and the
    output, empty and dense in x's layout."""
    fmt = layout(x)
    if fmt is None:
        raise ValueError(f"x must have NCHW or channels-last samples, got strides {x.stride()}")
    if residual is not None and layout(residual) != fmt and not (
            fmt == CHANNELS_LAST and _pixel_stride(residual) is not None):
        raise ValueError(f"residual must share x's layout ({fmt}): a mix of layouts is refused, "
                         f"got strides {residual.stride()} beside {x.stride()}")
    n, c, h, w = x.shape
    out_shape = (n, c, h // 2, w // 2) if pool else (n, c, h, w)
    nhwc = fmt == CHANNELS_LAST
    if nhwc and c > _MAX_NHWC_CHANNELS:
        raise ValueError(f"the channels-last kernel takes at most {_MAX_NHWC_CHANNELS} channels, got {c}")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last if nhwc else torch.contiguous_format)
    per_sample = out.numel() // max(n, 1)
    if per_sample > _LIMIT:
        raise ValueError(f"{tuple(x.shape)}: a sample of more elements than the kernel indexes")
    if nhwc:
        strides = (x.stride(0), _pixel_stride(x), *((c * h * w, c) if residual is None else
                                                     (residual.stride(0), _pixel_stride(residual))))
    else:
        strides = (x.stride(0), c, c * h * w if residual is None else residual.stride(0), c)
    v = 16 // x.element_size()
    if nhwc:  # a vector runs along the channels of a pixel
        fits = c % v == 0 and all(s % v == 0 for s in strides)
    else:  # along a sample (the pool form: along a row)
        fits = (w % (2 * v) == 0 if pool else per_sample % v == 0) and all(
            s % v == 0 for s in strides[0::2])
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out, residual) if t is not None)
    return fmt, strides, fits and aligned, out


def _launch(x, norm, conv_bias, residual, residual_norm, pool) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors, counted in
    ``batch_norm_act.launches`` and ``.paths``.  16-byte vectors where the
    shape and every pointer allow them, else one element a thread.  NCHW
    samples take the NCHW kernel, channels-last samples the NHWC kernel
    (:func:`_plan`); another layout, or a residual in the other layout, is
    refused, not run op by op."""
    fmt, strides, vector, out = _plan(x, residual, pool)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if out.numel() == 0:
        return out
    n, c, h, w = x.shape
    if n * (out.numel() // n // (16 // x.element_size() if vector else 1)) > _LIMIT:
        raise ValueError(f"{tuple(x.shape)} needs more threads than one launch of the kernel has")
    x_stride, x_pixel, r_stride, r_pixel = strides
    r = residual_norm
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bn_act_launch(
            x.data_ptr(), out.data_ptr(), None if residual is None else residual.data_ptr(),
            None if conv_bias is None else conv_bias.data_ptr(),
            norm.running_mean.data_ptr(), norm.running_var.data_ptr(),
            norm.weight.data_ptr(), norm.bias.data_ptr(), norm.eps,
            *((None,) * 4 if r is None else (r.running_mean.data_ptr(), r.running_var.data_ptr(),
                                             r.weight.data_ptr(), r.bias.data_ptr())),
            0.0 if r is None else r.eps,
            n, c, h, w, x_stride, r_stride, x_pixel, r_pixel, int(fmt == CHANNELS_LAST),
            int(x.dtype == torch.bfloat16), int(pool), int(vector), stream,
        )
    if err != 0:
        raise RuntimeError(f"batch_norm_act kernel launch failed: CUDA error {err}")
    batch_norm_act.launches += 1
    batch_norm_act.paths[f"{'vector' if vector else 'scalar'}/{fmt}"] += 1
    return out


def batch_norm_act(
    x: torch.Tensor,  # [N, C, H, W] float32 or bfloat16, NCHW or channels-last samples on CUDA
    norm: nn.BatchNorm2d,  # eval mode: its running statistics, weight and bias (f32 [C])
    conv_bias: Optional[torch.Tensor] = None,  # f32 [C], the preceding conv's bias
    residual: Optional[torch.Tensor] = None,  # x's shape, dtype and (on CUDA) layout
    residual_norm: Optional[nn.BatchNorm2d] = None,  # BN applied to the residual first
    pool: bool = False,  # then max-pool 2x2/2 (no residual)
) -> torch.Tensor:  # x's dtype and layout; [N, C, H // 2, W // 2] with pool
    """``ReLU(BN(x [+ conv_bias]) [+ residual | + BN_r(residual)])``, then
    ``max_pool2d(2, 2)`` if ``pool``, in one pass.  CUDA tensors launch the
    kernel, which takes NCHW or channels-last samples (:func:`layout`) and
    refuses another layout or a residual in the other one; CPU tensors take
    :func:`batch_norm_act_plain` in whatever layout.  The BatchNorms
    are read in eval mode whatever their ``training`` flag: the caller
    decides that this form applies."""
    _check(x, norm, conv_bias, residual, residual_norm, pool)
    if x.device.type == "cpu":
        return batch_norm_act_plain(x, norm, conv_bias, residual, residual_norm, pool)
    return _launch(x, norm, conv_bias, residual, residual_norm, pool)


batch_norm_act.launches = 0
batch_norm_act.paths = collections.Counter()
batch_norm_act.formats = collections.Counter()
