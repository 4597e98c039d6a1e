"""The port stands alone: no module of ``umetrack_torch`` and not
``chip_smoke.py`` imports JAX, flax, cv2, msgpack (the port has its own
codec) or the JAX package; and the kernel wrappers take the plain version
for CPU tensors."""
import ast
import importlib
import os

import pytest
import torch

from umetrack_torch.ops import bilinear_sample
from umetrack_torch.ops import warp_image as warp_image_module

# the package re-exports the wrapper under the module's own name
warp_pool_module = importlib.import_module("umetrack_torch.ops.warp_pool")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "msgpack", "umetrack_tpu")


def _port_sources():
    root = os.path.join(REPO, "umetrack_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_modules(path):
    with open(path) as fp:
        tree = ast.parse(fp.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_warp_pool_dispatches_cpu_tensors_to_plain(monkeypatch):
    calls = []

    def plain(images, coords, src_idx):
        calls.append(images.device)
        return torch.zeros(coords.shape[:3])

    monkeypatch.setattr(warp_pool_module, "bilinear_sample_pool_plain", plain)
    before = warp_pool_module.warp_pool.launches
    out = warp_pool_module.warp_pool(
        torch.zeros((1, 8, 8), dtype=torch.uint8), torch.zeros((2, 3, 4, 2)),
        torch.zeros((2,), dtype=torch.int32),
    )
    assert out.shape == (2, 3, 4)
    assert calls == [torch.device("cpu")]
    assert warp_pool_module.warp_pool.launches == before  # no kernel launch


@pytest.mark.parametrize("name", ["warp_image_full", "warp_image_windowed"])
def test_warp_image_dispatches_cpu_tensors_to_plain(monkeypatch, name):
    calls = []

    def plain(image, coords):
        calls.append(image.device)
        return torch.zeros(coords.shape[:-1])

    monkeypatch.setattr(warp_image_module, "bilinear_sample_plain", plain)
    wrapper = getattr(warp_image_module, name)
    before = (warp_image_module.warp_image_full.launches,
              warp_image_module.warp_image_windowed.launches)
    out = wrapper(torch.zeros((2, 480, 640), dtype=torch.uint8), torch.zeros((2, 3, 4, 2)))
    assert out.shape == (2, 3, 4)
    assert calls == [torch.device("cpu")]
    assert (warp_image_module.warp_image_full.launches,
            warp_image_module.warp_image_windowed.launches) == before  # no kernel launch


@pytest.mark.parametrize("method", ["kernel_full", "kernel_win"])
def test_kernel_sampler_on_cpu_tensor_raises(method):
    with pytest.raises(ValueError, match="CUDA"):
        bilinear_sample(torch.zeros((8, 8), dtype=torch.uint8), torch.zeros((3, 2)), method)
