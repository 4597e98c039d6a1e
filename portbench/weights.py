"""The weights both sides are given: read from a checkpoint file, or drawn
from the run's seed.

:func:`trained_state_dict` reads a flax msgpack checkpoint with the
benchmark's own frozen reader (:mod:`portbench.reference.data._msgpack` and
:mod:`portbench.reference.models.convert`), after checking the file's
SHA-256 against the one the configuration names: a checkpoint that changed
under the benchmark would change every cell's numbers.

:func:`draw_flax_init` draws flax's default initial distribution (conv and
dense kernels ``lecun_normal``: a normal of std 1/sqrt(fan_in) truncated at
two of its stds; zero biases; BatchNorm scale 1, bias 0, running mean 0,
running var 1) on the device from a ``torch.Generator``, in one draw for
all kernels.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict

import torch
from torch import nn

from .reference.data._msgpack import unpackb
from .reference.models.convert import from_flax_variables

# flax's ``variance_scaling(..., "truncated_normal")`` divides the standard
# deviation by that of a unit normal truncated to [-2, 2]
TRUNCATED_NORMAL_STD = 0.87962566103423978


def trained_state_dict(weights: dict, root: str = ".") -> Dict[str, torch.Tensor]:
    """The state dict of ``weights["file"]`` (a path from the checkout's
    root), whose SHA-256 must be ``weights["sha256"]``."""
    path = os.path.join(root, weights["file"])
    with open(path, "rb") as fp:
        data = fp.read()
    digest = hashlib.sha256(data).hexdigest()
    if digest != weights["sha256"]:
        raise ValueError(f"{path}: SHA-256 {digest}, the configuration names {weights['sha256']}")
    return from_flax_variables(unpackb(data))


def state_dict_for(config: dict, seed: int, device, root: str = ".") -> Dict[str, torch.Tensor]:
    """The weights the configuration names: ``{"file", "sha256"}`` read from
    the checkpoint, or ``{"draw": "flax_init"}`` drawn from ``seed`` on
    ``device``."""
    weights = config["weights"]
    if "file" in weights:
        return trained_state_dict(weights, root)
    if weights.get("draw") != "flax_init":
        raise ValueError(f"unknown weights {weights!r}")
    from .sides import REFERENCE, side

    ref = side(REFERENCE)
    model = ref.models.UmeTrackNet(ref.model_config(config)).to(device)
    return draw_flax_init(model, seed).state_dict()


@torch.no_grad()
def draw_flax_init(model: nn.Module, seed: int) -> nn.Module:
    """Overwrite ``model``'s parameters and BatchNorm statistics in place
    with flax's default draw, from a generator on the model's device seeded
    with ``seed``."""
    kernels = [m.weight for m in model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
    device = kernels[0].device
    generator = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.empty(sum(w.numel() for w in kernels), device=device)
    nn.init.trunc_normal_(flat, std=1.0, a=-2.0, b=2.0, generator=generator)
    offset = 0
    for w in kernels:
        std = w[0].numel() ** -0.5 / TRUNCATED_NORMAL_STD
        w.copy_(flat[offset: offset + w.numel()].view_as(w) * std)
        offset += w.numel()
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.reset_running_stats()
    return model
