"""The port stands alone: no module of ``umetrack_torch`` and not
``chip_smoke.py`` imports JAX, flax, msgpack (the port has its own codec),
orbax, tensorstore or zstandard (it has its own zstd decoder and OCDBT
store), the JAX package, the repository's ``scripts`` (the port's
drivers are ``umetrack_torch/scripts/``), its ``bench.py`` (the port is
measured by ``portbench``) or the tests' helpers; OpenCV is imported only inside the mp4 decoder and the
stroke renderer, which nothing on the GPU's path calls; and the kernel
wrappers take the plain version for CPU tensors."""
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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "msgpack", "umetrack_tpu",
             "zstandard", "tensorstore", "scripts",
             # the JAX bench (bench.py) and the tests' own helpers
             "bench", "tests", "synthetic", "conftest", "torch_threads")
# the only functions that may import cv2, by file
CV2_FUNCTIONS = {
    os.path.join("umetrack_torch", "tracker", "video.py"): {"stream_video_strip"},
    os.path.join("umetrack_torch", "utils", "synthetic.py"): {"draw_hands_on_image"},
}
NEW_MODULES = (
    "metrics.py", "apps/sequence_eval.py", "apps/run_eval_known_skeleton.py",
    "apps/run_eval_unknown_skeleton.py", "apps/load_eval.py", "utils/checkpoints.py",
    "utils/profiling.py", "utils/render.py", "tracker/video.py",
    "config.py", "parallel/train.py", "parallel/optim.py", "parallel/resident.py",
    "apps/train.py", "apps/distill.py",
    "parallel/eval.py", "parallel/distributed.py", "parallel/mesh.py", "parallel/collectives.py",
    "data/native.py",
    "utils/_zstd.py", "utils/ocdbt.py", "utils/orbax.py",
    "scripts/resident_train.py", "scripts/diagnose_ckpt.py", "scripts/accuracy_loop.py",
    "tracker/compiled.py", "ops/bn_act.py",
)


def _port_sources():
    root = os.path.join(REPO, "umetrack_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imports_of(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Import):
            yield from (a.name for a in sub.names)
        elif isinstance(sub, ast.ImportFrom) and sub.level == 0 and sub.module:
            yield sub.module
        elif isinstance(sub, ast.Call) and getattr(sub.func, "id", None) == "__import__":
            if sub.args and isinstance(sub.args[0], ast.Constant):
                yield str(sub.args[0].value)


def _imported_modules(path, skip_functions=()):
    """Every module ``path`` imports, at any depth; the bodies of the
    top-level functions named in ``skip_functions`` are left out."""
    with open(path) as fp:
        tree = ast.parse(fp.read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in skip_functions:
            continue
        yield from _imports_of(node)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_nothing_of_jax(path):
    rel = os.path.relpath(path, REPO)
    allowed = CV2_FUNCTIONS.get(rel, set())
    bad = [m for m in _imported_modules(path, allowed) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"
    # inside the named functions cv2 is allowed, and nothing else of the list
    inside = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert all(m == "cv2" for m in inside), f"{rel} imports {inside}"


def test_isolation_covers_the_eval_modules_and_the_cv2_functions_exist():
    sources = {os.path.relpath(p, os.path.join(REPO, "umetrack_torch")) for p in _port_sources()}
    assert set(NEW_MODULES) <= sources
    for rel, names in CV2_FUNCTIONS.items():
        with open(os.path.join(REPO, rel)) as fp:
            tree = ast.parse(fp.read())
        functions = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
        for name in names:
            assert "cv2" in set(_imports_of(functions[name])), f"{rel}::{name} no longer imports cv2"


def test_eval_modules_import_without_cv2():
    """The GPU machine has no OpenCV: importing the eval path's modules and
    generating unrendered or capsule-style data must not need it (a fresh
    interpreter in which ``import cv2`` raises)."""
    import subprocess
    import sys

    code = """
import sys
sys.modules["cv2"] = None  # import cv2 -> ImportError
import importlib
for name in ("tracker.video", "utils.synthetic", "utils.render", "apps.sequence_eval",
             "apps.run_eval_known_skeleton", "apps.run_eval_unknown_skeleton", "apps.load_eval",
             "config", "parallel.resident", "apps.train", "apps.distill",
             "scripts.resident_train", "scripts.diagnose_ckpt", "scripts.accuracy_loop"):
    importlib.import_module("umetrack_torch." + name)
from umetrack_torch.utils import synthetic
labels, images = synthetic.make_labels_dict(1, rng_seed=0, render=False, device="cpu")
assert images.shape == (1, 4, 480, 640)
try:
    synthetic.make_labels_dict(1, rng_seed=0, render_style="strokes", device="cpu")
except ImportError:
    print("strokes need cv2")
"""
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "strokes need cv2"


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
