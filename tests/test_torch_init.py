"""The port's initial weights against the JAX package's, on the CPU: every
JAX layer takes flax's default initialisers (``lecun_normal`` kernels, zero
biases, BatchNorm 1 / 0 with running stats 0 / 1), and every training
entry of the port must start from that distribution.  The same rule is
asserted on the JAX ``init_model``'s leaves and on the port's draws, read
through ``to_flax_variables`` as flax trees.  Also: the port's
``resident_train`` flags default to the JAX script's, so "the JAX
defaults" of a port run are the reference's training recipe."""
import ast
import os

import jax
import numpy as np
import pytest
import torch

from umetrack_tpu.models import init_model as jinit_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_torch.apps import distill, train as train_app
from umetrack_torch.config import Config
from umetrack_torch.models import ModelConfig, init_model, make_model
from umetrack_torch.models.convert import to_flax_variables
from umetrack_torch.parallel import init_train_model
from umetrack_torch.scripts import resident_train as rt
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(start_planes=8, backbone_blocks=(1, 1, 1, 1), n_image_feature_channels=12,
             n_memory_channels=6)
# flax's lecun_normal: a normal of std s / 0.8796..., truncated at two of
# those, so that the truncated draw has std s = 1/sqrt(fan_in)
MAX_SCALED = 2.0 / 0.8796
STD_RTOL = 0.05
MIN_KERNEL_SIZE = 1024  # below, the sample std of one draw is too loose to hold at 5 %
# the port's flags that the JAX script does not have: where it runs and
# writes, and splitting a run over several sittings
PORT_ONLY_FLAGS = {"--device", "--out-dir", "--state", "--stop-step"}


def _layers(variables):
    """(path, conv / dense {"kernel", "bias"}) and (path, BN {"scale",
    "bias", "mean", "var"}) of a flax variables tree."""
    dense, norms = [], []

    def walk(params, stats, path):
        if "kernel" in params:
            dense.append((path, params))
        elif "scale" in params:
            norms.append((path, {**params, **stats}))
        else:
            for key, sub in params.items():
                walk(sub, stats.get(key, {}), f"{path}/{key}")

    walk(variables["params"], variables.get("batch_stats", {}), "")
    return dense, norms


def assert_flax_default_draw(variables):
    """Every conv / dense kernel of at least ``MIN_KERNEL_SIZE`` elements
    has std * sqrt(fan_in) within 5 % of 1 (fan_in = kh*kw*c_in, the
    kernel's leading dims), every kernel |w| * sqrt(fan_in) <= 2 / 0.8796,
    every conv / dense bias is 0, every BN holds scale 1, bias 0, mean 0,
    var 1.  Returns the number of kernels held to the std."""
    dense, norms = _layers(jax.tree_util.tree_map(np.asarray, variables))
    assert dense and norms
    held = 0
    for path, leaves in dense:
        k = leaves["kernel"].astype(np.float64)
        root = np.sqrt(np.prod(k.shape[:-1]))
        assert np.abs(k).max() * root <= MAX_SCALED, path
        if k.size >= MIN_KERNEL_SIZE:
            assert abs(k.std() * root - 1.0) <= STD_RTOL, (path, k.std() * root)
            held += 1
        if "bias" in leaves:
            assert not np.any(leaves["bias"]), path
    for path, leaves in norms:
        for name, want in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
            assert np.all(leaves[name] == want), (path, name)
    return held


def _port(model_or_sd):
    sd = model_or_sd.state_dict() if isinstance(model_or_sd, torch.nn.Module) else model_or_sd
    return to_flax_variables(sd)


def _n_kernels(model):
    return sum(isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)) for m in model.modules())


def test_jax_init_model_draws_flax_defaults():
    """The rule is the JAX package's: its ``init_model`` at the small config."""
    jvars = jax.jit(lambda key: jinit_model(key, JModelConfig(**SMALL))[1])(jax.random.PRNGKey(0))
    assert assert_flax_default_draw(jvars) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_port_init_model_draws_flax_defaults(seed):
    model, sd = init_model(torch.Generator().manual_seed(seed), ModelConfig(**SMALL))
    dense, _ = _layers(_port(sd))
    assert len(dense) == _n_kernels(model)
    assert assert_flax_default_draw(_port(sd)) > 0
    assert all(torch.equal(a, b) for a, b in zip(
        sd.values(), make_model(ModelConfig(**SMALL), seed=seed).state_dict().values()))


def test_port_init_train_model_draws_flax_defaults():
    model = init_train_model(ModelConfig(**SMALL), seed=0, device="cpu")
    assert assert_flax_default_draw(_port(model)) > 0


class _Reached(Exception):
    pass


@pytest.fixture
def spy_init(monkeypatch):
    """Patches ``init_train_model`` in a module to record the model that
    module's training entry draws, then stop the entry."""
    drawn = []

    def spy(module):
        def init(*args, **kwargs):
            drawn.append((args, kwargs, init_train_model(*args, **kwargs)))
            raise _Reached

        monkeypatch.setattr(module, "init_train_model", init)
        return drawn

    return spy


def test_every_training_entry_starts_from_the_flax_draw(spy_init, monkeypatch):
    """``resident_train train``, ``apps/train.py::run_training`` and the
    distillation's student (seed + 1, as JAX's ``distill.py``) reach
    ``init_train_model``, which draws the rule at full width."""
    monkeypatch.setattr(rt, "_corpora", lambda args, device: (None, None))
    monkeypatch.setattr(distill, "build_teacher", lambda *args, **kwargs: None)
    entries = (
        (rt, lambda: rt.main(["train", "--device", "cpu", "--dtype", "float32"])),
        (train_app, lambda: train_app.run_training(Config(), iter(()), device="cpu")),
        (distill, lambda: distill.run_distillation(steps=1, seed=4, device="cpu")),
    )
    for module, entry in entries:
        drawn = spy_init(module)
        with pytest.raises(_Reached):
            entry()
    assert [kw.get("seed", args[1] if len(args) > 1 else None) for args, kw, _ in drawn] == [0, 0, 5]
    for _, _, model in drawn:
        assert _n_kernels(model) == 46  # the full ModelConfig()
        assert assert_flax_default_draw(_port(model)) > 0


def _jax_resident_train_flags():
    """flag -> (default, type name, action) of the ``p.add_argument`` calls
    in the JAX ``scripts/resident_train.py::main``, read with ``ast``."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "resident_train.py")).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    flags = {}
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            action = ast.literal_eval(kw["action"]) if "action" in kw else None
            default = ast.literal_eval(kw["default"]) if "default" in kw else (
                False if action == "store_true" else None)
            flags[ast.literal_eval(node.args[0])] = (
                default, kw["type"].id if "type" in kw else None, action)
    return flags


def test_resident_train_defaults_are_the_jax_recipe():
    want = _jax_resident_train_flags()
    assert want["--steps"][0] == 30_000 and want["--dtype"][0] == "bfloat16"
    got = {}
    for action in rt.build_parser()._actions:
        if action.dest == "help":
            continue
        flag = action.option_strings[0] if action.option_strings else action.dest
        kind = {"_StoreTrueAction": "store_true"}.get(type(action).__name__)
        got[flag] = (action.default, getattr(action.type, "__name__", None), kind)
    assert set(got) - set(want) == PORT_ONLY_FLAGS
    assert {flag: got[flag] for flag in want} == want
