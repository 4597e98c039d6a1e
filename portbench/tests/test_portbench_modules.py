"""A configuration names the module its reference builds its model from.

The program always builds ``umetrack_torch.models``, whose ``ModelConfig``
chooses the architecture.  Without a ``"reference_module"`` key every
configuration builds the classes of each side's ``models`` and draws or
reads the same weights as before.  With one, the reference builds the module
it names: here a small alternative assembly (``UmeTrackNet`` with a
patch-attention image trunk in place of the ResNet, and a ``ModelConfig``
with the trunk's widths), written once below, registered for the test under
the reference's package, and put in the program's ``models`` as a program
that adds the architecture would.  Each configuration that names a module
draws the program's state dict, at the widths the CPU tests build it at.  A
module outside the reference, or a draw it does not have, is refused before
set-up.

Run: ``python -m pytest portbench/tests -q`` from the checkout's root.
"""
import sys
import time
import types

import pytest
import torch

from portbench import faults, harness, sides, weights
from portbench.entries import batched
from portbench.entries.train import REHEARSAL_MODEL as SMALL
from portbench.reference.data._msgpack import unpackb
from portbench.reference.models.convert import from_flax_variables
from portbench.tests.test_portbench_harness import BENCHMARK, FORBIDDEN, ROOT, _imported

CONFIGS = [c["name"] for c in BENCHMARK["configs"]]
NAMED = [c for c in CONFIGS if "reference_module" in harness.load_config(c)]
PLAIN = [c for c in CONFIGS if c not in NAMED]
ASSEMBLY = '''
"""UmeTrackNet with a patch-attention image trunk in place of the ResNet."""
import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from {package}.models import ModelConfig as _ModelConfig, UmeTrackNet as _UmeTrackNet
from {package}.models.backbone import Conv, Dense

BUILT = []  # one entry for each UmeTrackNet built


@dataclasses.dataclass(frozen=True)
class ModelConfig(_ModelConfig):
    patch_size: int = 16
    trunk_width: int = 16
    trunk_heads: int = 2

    @property
    def feature_map_size(self):
        return (self.input_size[0] // self.patch_size, self.input_size[1] // self.patch_size)


class PatchTrunk(nn.Module):
    """[N, 1, H, W] -> [N, C_img, H/p, W/p]: patch embedding and position
    embeddings, one pre-LayerNorm attention block with a GELU MLP, a 1x1
    projection."""

    def __init__(self, cfg):
        super().__init__()
        d, w = cfg.torch_dtype, cfg.trunk_width
        h, v = cfg.feature_map_size
        self.heads = cfg.trunk_heads
        self.patch = Conv(1, w, cfg.patch_size, stride=cfg.patch_size, bias=True, compute_dtype=d)
        self.pos = nn.Parameter(torch.zeros(1, h * v, w))
        self.norm1, self.norm2 = nn.LayerNorm(w), nn.LayerNorm(w)
        self.qkv = Dense(w, 3 * w, compute_dtype=d)
        self.out = Dense(w, w, compute_dtype=d)
        self.fc1 = Dense(w, 2 * w, compute_dtype=d)
        self.fc2 = Dense(2 * w, w, compute_dtype=d)
        self.proj_conv = Conv(w, cfg.n_image_feature_channels, 1, bias=True, compute_dtype=d)

    @staticmethod
    def _norm(norm, t):
        return F.layer_norm(t.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(t.dtype)

    def forward(self, x):
        x = self.patch(x)
        n, c, h, v = x.shape
        t = x.flatten(2).transpose(1, 2) + self.pos.to(x.dtype)
        qkv = self.qkv(self._norm(self.norm1, t)).view(n, h * v, 3, self.heads, c // self.heads)
        q, k, val = qkv.permute(2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, val)
        t = t + self.out(a.transpose(1, 2).reshape(n, h * v, c))
        t = t + self.fc2(F.gelu(self.fc1(self._norm(self.norm2, t))))
        return self.proj_conv(t.transpose(1, 2).reshape(n, c, h, v))


class UmeTrackNet(_UmeTrackNet):
    def __init__(self, config=None):
        super().__init__(config or ModelConfig())
        self.backbone = PatchTrunk(self.config)
        BUILT.append(type(self.config).__name__)
'''
# the reference's own draw: flax's for the convs and dense layers, then the
# position embeddings from a normal of std 0.02 truncated at two of its stds
REFERENCE_DRAW = '''

def draw_patch_trunk(model, seed):
    from portbench.weights import draw_flax_init

    draw_flax_init(model, seed)
    pos = model.backbone.pos
    generator = torch.Generator(device=pos.device).manual_seed((int(seed) + 1) % 2**63)
    nn.init.trunc_normal_(pos, std=0.02, a=-0.04, b=0.04, generator=generator)
    return model
'''
PROGRAM_ASSEMBLY = "_patch_trunk_program"
REFERENCE_MODULE = f"{sides.REFERENCE}.models._patch_trunk"
TRUNK = dict(patch_size=16, trunk_width=16, trunk_heads=2)


def register(name: str, source: str) -> types.ModuleType:
    module = types.ModuleType(name)
    sys.modules[name] = module
    exec(compile(source, f"<{name}>", "exec"), module.__dict__)
    return module


@pytest.fixture
def assembly(monkeypatch):
    """The alternative assembly for the test's length: the program's
    ``models`` building it, and the reference module that names it;
    ``(program assembly, reference module)``."""
    program = register(PROGRAM_ASSEMBLY, ASSEMBLY.format(package=sides.PROGRAM))
    reference = register(REFERENCE_MODULE, ASSEMBLY.format(package=sides.REFERENCE) + REFERENCE_DRAW)
    models = sides.side(sides.PROGRAM).models
    monkeypatch.setattr(models, "ModelConfig", program.ModelConfig)
    monkeypatch.setattr(models, "UmeTrackNet", program.UmeTrackNet)
    try:
        yield program, reference
    finally:
        for name in (PROGRAM_ASSEMBLY, REFERENCE_MODULE):
            sys.modules.pop(name, None)


def alt_config() -> dict:
    """``umetrack_known`` with the alternative assembly, at a tiny width,
    its weights drawn by the reference module's own draw."""
    config = harness.load_config("umetrack_known")
    return {**config, "reference_module": REFERENCE_MODULE, "weights": {"draw": "patch_trunk"},
            "model": {**config["model"], **SMALL, **TRUNK}}


def widths(config: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in config["model"].items()}


def refused_context(config: dict, match: str):
    """``harness.context`` refuses ``config`` before set-up."""
    with pytest.raises(ValueError, match=match):
        harness.context("known.batched", 1, 1.0, False, "cpu", time.perf_counter(), ROOT, config=config)


@pytest.mark.parametrize("name", PLAIN)
def test_a_configuration_without_a_reference_module_builds_and_draws_as_before(name):
    """Each side resolves to its package's ``models``; the drawn or read
    state dict is what the lookup-free path gives, key for key and bit for
    bit."""
    config = harness.load_config(name)
    assert "reference_module" not in config
    for package in (sides.PROGRAM, sides.REFERENCE):
        side = sides.side(package)
        default = sys.modules[f"{package}.models"]
        assert side.models_for(config) is default
        assert type(side.model_config(config)) is default.ModelConfig
    ref, port = sides.side(sides.REFERENCE), sides.side(sides.PROGRAM)
    port_keys = set(port.models.UmeTrackNet(port.models.ModelConfig(**widths(config))).state_dict())
    for seed in (7, 2**31 + 5):
        got = weights.state_dict_for(config, seed, "cpu", ROOT)
        if "file" in config["weights"]:
            with open(f"{ROOT}/{config['weights']['file']}", "rb") as fp:
                want = from_flax_variables(unpackb(fp.read()))
        else:
            want = weights.draw_flax_init(
                ref.models.UmeTrackNet(ref.models.ModelConfig(**widths(config))), seed).state_dict()
        assert list(got) == list(want) and set(want) == port_keys
        for key in want:
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("name", NAMED + [PROGRAM_ASSEMBLY])
def test_a_configuration_naming_a_reference_module_draws_the_programs_state_dict(name, request):
    """Each configuration of ``BENCHMARK.json`` that names a reference
    module, and this file's assembly: the weights drawn or read for it have
    exactly the keys, shapes and dtypes of the program's
    ``UmeTrackNet(ModelConfig(**model))``, at the configuration's
    ``"rehearsal_model"`` widths where it declares them (the CPU's sizes);
    two draws at one seed are equal bit for bit, and drawn weights differ
    between two seeds."""
    if name == PROGRAM_ASSEMBLY:
        request.getfixturevalue("assembly")
        config = alt_config()
    else:
        config = harness.load_config(name)
        config = {**config, "model": {**config["model"], **config.get("rehearsal_model", {})}}
    models = sides.side(sides.PROGRAM).models
    want = models.UmeTrackNet(models.ModelConfig(**widths(config))).state_dict()
    a, b, c = (weights.state_dict_for(config, seed, "cpu", ROOT) for seed in (7, 7, 2**31 + 5))
    assert set(a) == set(want)
    for key in want:
        assert (a[key].shape, a[key].dtype) == (want[key].shape, want[key].dtype), key
        assert torch.equal(a[key], b[key]), key
    if "draw" in config["weights"]:
        assert any(not torch.equal(a[key], c[key]) for key in a)


@pytest.mark.parametrize("name", CONFIGS)
def test_each_configurations_reference_module_imports_nothing_of_the_program(name):
    """The module each configuration of ``BENCHMARK.json`` names for its
    reference (or the default), imported alone in a fresh process, loads
    nothing of the program and nothing of JAX."""
    module = sides.reference_module(harness.load_config(name))
    found = _imported(f"import {module}, portbench.weights")
    assert not found & (set(FORBIDDEN) | {sides.PROGRAM})


def test_a_named_reference_module_resolves(assembly):
    program, reference = assembly
    config = alt_config()
    state_dict = weights.state_dict_for(config, 3, "cpu", ROOT)
    assert "backbone.pos" in state_dict and not any(k.startswith("backbone.stem") for k in state_dict)
    for package, module in ((sides.PROGRAM, program), (sides.REFERENCE, reference)):
        side = sides.side(package)
        model_config = side.model_config(config)
        assert type(model_config) is module.ModelConfig and model_config.trunk_width == TRUNK["trunk_width"]
        model = side.model(config, state_dict, "cpu")
        assert type(model) is module.UmeTrackNet and type(model.backbone).__name__ == "PatchTrunk"
        assert side.zero_state(model, 2, "cpu").temporal.mem_features.shape[-2:] == (6, 6)
    assert sides.side(sides.REFERENCE).models_for(config) is reference
    assert sides.side(sides.PROGRAM).models_for(config) is sys.modules[f"{sides.PROGRAM}.models"]
    # the default reference's ModelConfig refuses the trunk's widths: the wall the lookup opens
    with pytest.raises(TypeError):
        sides.side(sides.REFERENCE).model_config({k: v for k, v in config.items() if k != "reference_module"})


@pytest.mark.parametrize("name", [
    f"{sides.PROGRAM}.models",
    f"{sides.REFERENCE}x.models",
    sides.REFERENCE,
    "elsewhere.models",
    "portbench.weights",
    f"{sides.REFERENCE}..models",
    3,
    [f"{sides.REFERENCE}.models"],
], ids=repr)
def test_a_reference_module_outside_the_reference_is_refused_before_set_up(name):
    """Refused by name, in ``harness.context``, before a module is imported,
    the weights read or drawn, or a model built."""
    reference = sides.side(sides.REFERENCE)
    for config_name in ("umetrack_known", "umetrack_known_f32"):
        config = {**harness.load_config(config_name), "reference_module": name}
        before = set(sys.modules)
        refused_context(config, "reference_module")
        with pytest.raises(ValueError, match="reference_module"):
            weights.state_dict_for(config, 1, "cpu", ROOT)
        with pytest.raises(ValueError, match="reference_module"):
            reference.model_config(config)
        assert set(sys.modules) == before


def test_a_module_without_the_contract_is_refused():
    bare = register(f"{sides.REFERENCE}.models._bare", "ModelConfig = None")
    try:
        refused_context({**harness.load_config("umetrack_known"), "reference_module": bare.__name__},
                        "UmeTrackNet")
    finally:
        sys.modules.pop(bare.__name__)


def test_a_named_draw_is_called_and_an_unknown_one_raises(assembly, monkeypatch):
    _, reference = assembly
    calls = []
    monkeypatch.setattr(reference, "draw_counted", lambda model, seed: calls.append((type(model), seed)),
                        raising=False)
    config = alt_config()
    weights.state_dict_for({**config, "weights": {"draw": "counted"}}, 11, "cpu", ROOT)
    assert calls == [(reference.UmeTrackNet, 11)]
    built = len(reference.BUILT)
    refused_context({**config, "weights": {"draw": "nowhere"}}, "draw_nowhere")
    with pytest.raises(ValueError, match="draw_nowhere"):
        weights.state_dict_for({**config, "weights": {"draw": "nowhere"}}, 11, "cpu", ROOT)
    assert len(reference.BUILT) == built  # refused before the model was built
    refused_context({**harness.load_config("umetrack_known_f32"), "weights": {"draw": "nowhere"}},
                    "draw_nowhere")
    # the module's draw is seeded, and flax_init stays draw_flax_init
    a, b = (weights.state_dict_for(config, s, "cpu", ROOT) for s in (5, 5))
    c = weights.state_dict_for(config, 6, "cpu", ROOT)
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["backbone.pos"], c["backbone.pos"])
    assert 0 < a["backbone.pos"].abs().max() <= 0.04
    flax = weights.state_dict_for({**config, "weights": {"draw": "flax_init"}}, 5, "cpu", ROOT)
    assert torch.equal(flax["backbone.pos"], torch.zeros_like(flax["backbone.pos"]))
    assert all(torch.equal(flax[k], a[k]) for k in a if k != "backbone.pos")


@pytest.mark.parametrize("fault", [None, "answer_altered", "state_unchanged"])
def test_the_batched_entry_runs_another_architecture_on_both_sides(assembly, fault):
    """``entries/batched.py`` rehearsed on the CPU at the tiny size, the
    program's ``models`` and the named reference module both building the
    alternative assembly: correct, and not once a fault is planted in the
    program."""
    program, reference = assembly
    torch.set_num_threads(2)
    cell = "known.batched"
    spec = harness.load_cell(cell)
    ctx = harness.context(cell, 2**31 + 9, 1.0, False, "cpu", time.perf_counter(), ROOT,
                          cell={"traffic": {**spec["traffic"], **batched.REHEARSAL}}, config=alt_config())
    if fault is None:
        result = harness.run_cell(ctx, BENCHMARK)
        assert result["correct"] is True, result["compared"]
        assert all(c["value"] == 0.0 for c in result["compared"].values())
    else:
        with faults.plant(fault):
            result = harness.run_cell(ctx, BENCHMARK)
        assert result["correct"] is False, result["compared"]
    assert program.BUILT and reference.BUILT
