"""The tracker's compiled steps (``umetrack_torch/tracker/compiled.py``),
the port's counterpart of the JAX tracker's ``jax.jit``, on the CPU: the
cache key, the capture / replay plumbing with a CPU stand-in for
``torch.cuda.CUDAGraph`` (a "graph" that re-runs the captured function on
the static inputs and copies into the static outputs), the pool warp's
range check on the CUDA path reading no value on the host, the captured
steps making no host round trip, and the three public entry points,
replayed on other inputs than they were captured on, against the JAX
tracker (small config, f32, the JAX tests' bounds)."""
import copy
import dataclasses
import importlib
import traceback

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch.overrides import TorchFunctionMode

import synthetic
from umetrack_tpu.models import init_model, make_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.models.umetrack import TemporalState as JTemporalState
from umetrack_tpu.tracker import HandTracker as JHandTracker
from umetrack_tpu.tracker import TrackerConfig as JTrackerConfig
from umetrack_tpu.tracker.tracker import track_sequences_batched as jbatched
from umetrack_tpu.tracker.types import TrackState as JTrackState
from umetrack_torch.kinematics.hand import stack_hand_models
from umetrack_torch.models import ModelConfig, UmeTrackNet, from_flax_variables
from umetrack_torch.tracker import HandTracker, TrackerConfig, TrackState
from umetrack_torch.tracker import compiled
from umetrack_torch.tracker import tracker as port_tracker
from umetrack_torch.utils.synthetic import our_sequence
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

# the package re-exports the wrapper under the module's own name
warp_pool_module = importlib.import_module("umetrack_torch.ops.warp_pool")

SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
T_FRAMES = 4
ANGLE_TOL, WRIST_TOL_MM, SCALE_TOL = 1e-3, 0.1, 2e-3  # tests/test_tracker.py:215,356-360


def _stacked(*trees):
    """Tensor dataclasses of one kind stacked along a new leading dim."""
    return dataclasses.replace(trees[0], **{
        f.name: torch.stack([getattr(t, f.name) for t in trees])
        for f in dataclasses.fields(trees[0])
    })


@pytest.fixture(scope="module")
def setup():
    jcfg = JModelConfig(**SMALL)
    jvars = jax.jit(lambda key: init_model(key, jcfg)[1])(jax.random.PRNGKey(5))
    variables = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jvars)
    rng = np.random.default_rng(1)
    variables["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.random(a.shape) * 0.2).astype(np.float32), variables["batch_stats"]
    )
    # move the weights off flax's zero biases so that the scale head varies
    variables["params"] = jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.05).astype(np.float32), variables["params"]
    )
    cfg = ModelConfig(**SMALL)
    model = UmeTrackNet(cfg)
    model.load_state_dict(from_flax_variables(variables, cfg))
    seqs, jseqs = {}, {}
    for name, seed in (("a", 13), ("b", 21)):
        labels, images = synthetic.make_labels_dict(T_FRAMES, rng_seed=seed, render=False)
        seqs[name] = our_sequence(labels, images, "cpu")
        jseqs[name] = synthetic.our_sequence(labels, images)
    return dict(
        jtracker=JHandTracker(
            make_model(jcfg), jax.tree_util.tree_map(jnp.asarray, variables),
            JTrackerConfig(sampler="pallas_pool"),
        ),
        tracker=HandTracker(model, device="cpu"),
        seqs=seqs, jseqs=jseqs,
    )


# ---- the CPU stand-in for a CUDA graph ------------------------------------------


class FakeGraph:
    """Replays by re-running the captured function on the static inputs
    (with the launch counters held, as a replay runs no Python) and copying
    its results into the static outputs."""

    def __init__(self, run, outputs):
        self.run, self.outputs = run, outputs
        self.replays, self.was_reset = 0, False

    def replay(self):
        saved = compiled._read_counts()
        fresh = self.run()
        compiled._restore_counts(saved)
        for dst, src in zip(compiled._leaves(self.outputs), compiled._leaves(fresh)):
            dst.copy_(src)
        self.replays += 1

    def reset(self):
        self.was_reset = True


class FakeGraphs:
    """``compiled.GRAPHS`` for CPU tensors."""

    def __init__(self, fail=None):
        self.graphs, self.fail = [], fail

    @staticmethod
    def applies(device):
        return True

    def capture(self, run, device):
        outputs = run()
        if self.fail:
            raise RuntimeError(self.fail)
        self.graphs.append(FakeGraph(run, outputs))
        return self.graphs[-1], outputs, 0


@pytest.fixture
def fake_graphs(monkeypatch):
    compiled.release()
    fake = FakeGraphs()
    monkeypatch.setattr(compiled, "GRAPHS", fake)
    yield fake
    compiled.release()


class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(3))


def toy_step(model, x, scale):
    """A step that "launches" the pool kernel once (its counters, as
    ``ops/warp_pool.py::_launch`` moves them) and returns a tuple tree."""
    warp_pool_module.warp_pool.launches += 1
    warp_pool_module.warp_pool.paths["vector"] += 1
    return x * scale + model.weight, (x.sum(dim=-1),)


def _toy_call(step, model, x, scale=2.0):
    return step(model, torch.device("cpu"), dict(x=x), scale=scale)


# ---- the key ---------------------------------------------------------------------


def _frame_inputs(setup, name="a", frame=0):
    rig, seq, hand = setup["seqs"][name]
    state = setup["tracker"].init_state()
    return dict(rig=rig, obs=seq.map(lambda a: a[frame]), state=state, hand_model_mm=hand)


def _frame_key(setup, model=None, inputs=None, **static):
    static = {"config": TrackerConfig(), "min_num_crops": 1, "known": True, "sampler": "plain",
              **static}
    return port_tracker._FRAME.key(
        model or setup["tracker"].model, inputs or _frame_inputs(setup), static, torch.device("cpu"))


def _flip(module, name):
    def apply(monkeypatch):
        monkeypatch.setattr(module, name, not getattr(module, name))
    return apply


KEY_CHANGES = {
    "cuda_matmul_tf32": _flip(torch.backends.cuda.matmul, "allow_tf32"),
    "cudnn_tf32": _flip(torch.backends.cudnn, "allow_tf32"),
    "cudnn_enabled": _flip(torch.backends.cudnn, "enabled"),
    "cudnn_deterministic": _flip(torch.backends.cudnn, "deterministic"),
    "cudnn_benchmark": _flip(torch.backends.cudnn, "benchmark"),
}


@pytest.mark.parametrize("flag", sorted(KEY_CHANGES))
def test_key_changes_with_each_backend_flag(setup, monkeypatch, flag):
    before = _frame_key(setup)
    KEY_CHANGES[flag](monkeypatch)
    assert _frame_key(setup) != before
    monkeypatch.undo()
    assert _frame_key(setup) == before


@pytest.mark.parametrize("change", [
    "compute_dtype", "image_shape", "image_dtype", "state_rows", "known", "min_num_crops",
    "sampler", "tracker_config", "parameter_storage", "parameter_object", "submodule", "train_mode",
])
def test_key_changes_with_what_a_capture_bakes_in(setup, change):
    base = _frame_key(setup)
    inputs = _frame_inputs(setup)
    model = setup["tracker"].model
    if change == "compute_dtype":
        other = UmeTrackNet(ModelConfig(**SMALL, compute_dtype="bfloat16"))
        other.load_state_dict(model.state_dict())
        key = _frame_key(setup, model=other)
        # the same weights in a model of the same dtype at other addresses
        same = UmeTrackNet(ModelConfig(**SMALL))
        same.load_state_dict(model.state_dict())
        assert key[3:5] != _frame_key(setup, model=same)[3:5]
    elif change == "image_shape":
        inputs["obs"] = inputs["obs"].map(lambda a: a[..., :-1, :] if a.dtype == torch.uint8 else a)
        key = _frame_key(setup, inputs=inputs)
    elif change == "image_dtype":
        inputs["obs"] = inputs["obs"].map(lambda a: a.float() if a.dtype == torch.uint8 else a)
        key = _frame_key(setup, inputs=inputs)
    elif change == "state_rows":
        inputs["state"] = TrackState.init(model.config, 4)
        key = _frame_key(setup, inputs=inputs)
    elif change == "known":
        key = _frame_key(setup, known=False)
    elif change == "min_num_crops":
        key = _frame_key(setup, min_num_crops=2)
    elif change == "sampler":
        key = _frame_key(setup, sampler="plain_image")
    elif change == "tracker_config":
        key = _frame_key(setup, config=TrackerConfig(enable_memory=False))
    elif change == "parameter_storage":
        other = UmeTrackNet(ModelConfig(**SMALL))
        other.load_state_dict(model.state_dict())
        before = _frame_key(setup, model=other)
        p = next(other.parameters())
        p.data = p.data.clone()  # the same values at another address
        key = _frame_key(setup, model=other)
        assert key[2] == before[2]  # the same model
        base = before
    elif change in ("parameter_object", "submodule"):
        other = UmeTrackNet(ModelConfig(**SMALL))
        other.load_state_dict(model.state_dict())
        base = _frame_key(setup, model=other)
        conv = other.backbone.stem_conv
        if change == "parameter_object":  # a new Parameter of the same values
            conv.weight = torch.nn.Parameter(conv.weight.detach().clone())
        else:  # a new module of the same weights
            other.backbone.stem_conv = copy.deepcopy(conv)
        key = _frame_key(setup, model=other)
    else:
        model.train()
        try:
            key = _frame_key(setup)
        finally:
            model.eval()
    assert key != base


def test_key_is_stable_for_equal_inputs_and_in_place_loads(setup):
    base = _frame_key(setup)
    fresh = {name: tree.map(torch.clone) for name, tree in _frame_inputs(setup).items()}
    assert _frame_key(setup, inputs=fresh) == base
    model = setup["tracker"].model
    model.load_state_dict(model.state_dict())  # in place: the same storage
    assert _frame_key(setup) == base
    other = _frame_inputs(setup, "b", frame=2)  # other values, the same shapes
    assert _frame_key(setup, inputs=other) == base


def test_key_tells_a_skeleton_override_apart(setup):
    rig, seq, hand = setup["seqs"]["a"]
    inputs = dict(rig=rig, seq=seq, init_state=setup["tracker"].init_state(), hand_model_mm=hand,
                  skel_hand_model_mm=None)
    static = {"config": TrackerConfig(), "min_num_crops": 1, "sampler": "plain"}
    model, cpu = setup["tracker"].model, torch.device("cpu")
    without = port_tracker._SEQUENCE.key(model, inputs, static, cpu)
    assert port_tracker._SEQUENCE.key(model, dict(inputs, skel_hand_model_mm=hand), static, cpu) != without


# ---- the plumbing ------------------------------------------------------------------


def test_cpu_runs_the_step_directly():
    compiled.release()
    step = compiled.CompiledStep(toy_step)
    x = torch.arange(6.0).reshape(2, 3)
    out, (total,) = _toy_call(step, Toy(), x)
    torch.testing.assert_close(out, x * 2 + 1)
    assert compiled.cached() == []


def test_replay_copies_the_inputs_in_and_clones_the_outputs(fake_graphs):
    step, model = compiled.CompiledStep(toy_step), Toy()
    a, b, c = (torch.full((2, 3), v) for v in (1.0, 5.0, 7.0))
    first, _ = _toy_call(step, model, a)  # eager, then captured on a copy of a
    torch.testing.assert_close(first, a * 2 + 1)
    (captured,) = compiled.cached()
    assert len(fake_graphs.graphs) == 1 and fake_graphs.graphs[0].replays == 0
    out_b, (sum_b,) = _toy_call(step, model, b)
    assert fake_graphs.graphs[0].replays == 1
    torch.testing.assert_close(captured.inputs[0], b)  # copied in before the replay
    torch.testing.assert_close(out_b, b * 2 + 1)
    torch.testing.assert_close(sum_b, b.sum(dim=-1))
    out_c, _ = _toy_call(step, model, c)
    torch.testing.assert_close(out_b, b * 2 + 1)  # a clone: the next replay left it alone
    torch.testing.assert_close(out_c, c * 2 + 1)
    static_out = captured.outputs[0]
    assert out_b.data_ptr() != static_out.data_ptr() != out_c.data_ptr()
    assert len(fake_graphs.graphs) == 1  # equal keys: no recapture
    # an in-place load keeps the key, and the replay reads the new weights
    with torch.no_grad():
        model.weight.copy_(torch.full((3,), 10.0))
    out_c2, _ = _toy_call(step, model, c)
    torch.testing.assert_close(out_c2, c * 2 + 10)
    assert len(fake_graphs.graphs) == 1
    # other static arguments are another key
    _toy_call(step, model, c, scale=3.0)
    assert len(fake_graphs.graphs) == 2


def test_replay_advances_the_launch_counters(fake_graphs):
    wp = warp_pool_module.warp_pool
    step, model = compiled.CompiledStep(toy_step), Toy()
    x = torch.ones(2, 3)
    wp.launches = 0
    wp.paths.clear()
    _toy_call(step, model, x)
    # the eager first run launched once; the capture launched nothing
    assert wp.launches == 1 and wp.paths == {"vector": 1}
    assert compiled.cached()[0].launched[0] == (1, {"paths": {"vector": 1}})
    for n in range(2, 5):
        _toy_call(step, model, x)
        assert wp.launches == n and wp.paths == {"vector": n}


def test_the_cache_keeps_the_newest_keys_and_resets_the_rest(fake_graphs):
    step, model = compiled.CompiledStep(toy_step), Toy()
    shapes = [(1, 3), (2, 3), (3, 3), (4, 3), (5, 3)]
    for shape in shapes[:compiled.CAPACITY]:
        _toy_call(step, model, torch.ones(shape))
    _toy_call(step, model, torch.ones(shapes[0]))  # a replay: now the newest
    assert fake_graphs.graphs[0].replays == 1
    _toy_call(step, model, torch.ones(shapes[compiled.CAPACITY]))
    assert len(compiled.cached()) == compiled.CAPACITY
    evicted = [g for g in fake_graphs.graphs if g.was_reset]
    assert evicted == [fake_graphs.graphs[1]]  # the least recently used
    assert [c.inputs[0].shape[0] for c in compiled.cached()] == [3, 4, 1, 5]
    compiled.release()
    assert compiled.cached() == [] and all(g.was_reset for g in fake_graphs.graphs)


def test_a_failed_capture_raises_with_the_key_and_restores_the_counters(monkeypatch):
    compiled.release()
    monkeypatch.setattr(compiled, "GRAPHS", FakeGraphs(fail="operation not permitted when stream is capturing"))
    wp = warp_pool_module.warp_pool
    wp.launches = 0
    with pytest.raises(RuntimeError, match="toy_step: CUDA graph capture failed for key .*not permitted"):
        _toy_call(compiled.CompiledStep(toy_step), Toy(), torch.ones(2, 3))
    assert wp.launches == 1  # the eager run's launch; none from the capture
    assert compiled.cached() == []


# ---- no host read on the card's path ----------------------------------------------


def test_the_cuda_range_check_reads_no_value_on_the_host(monkeypatch):
    """On a tensor that is not on the CPU ``_check`` hands the range to a
    device-side assert; ``meta`` tensors have no values, so any ``int()`` or
    ``.item()`` of one would raise here."""
    asserted = []
    real = torch._assert_async
    monkeypatch.setattr(torch, "_assert_async", lambda cond, *msg: asserted.append(cond) or real(cond, *msg))
    pool = torch.empty((2, 20, 32), dtype=torch.uint8, device="meta")
    coords = torch.empty((3, 4, 8, 2), dtype=torch.float32, device="meta")
    src_idx = torch.empty((3,), dtype=torch.int32, device="meta")
    warp_pool_module._check(pool, coords, src_idx)
    assert len(asserted) == 1 and asserted[0].device.type == "meta" and asserted[0].dtype == torch.bool
    with pytest.raises(RuntimeError, match="meta"):
        int(src_idx.amax())  # what the check must not do
    warp_pool_module._check(pool, coords[:0], src_idx[:0])  # nothing to check
    assert len(asserted) == 1


HOST_READS = {
    torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__bool__, torch.Tensor.__int__,
    torch.Tensor.__float__, torch.Tensor.__index__, torch.Tensor.numpy, torch.Tensor.cpu,
    torch.nonzero, torch.Tensor.nonzero, torch.masked_select, torch.Tensor.masked_select,
    torch.unique, torch.argwhere, torch.tensor, torch.Tensor.new_tensor, torch.from_numpy,
    torch.repeat_interleave, torch.Tensor.repeat_interleave,
}


class HostReads(TorchFunctionMode):
    """Records every call that reads a tensor's values on the host or copies
    host data to the device (on a card: a wait, or a copy a CUDA graph
    cannot capture), by the port's line that made it."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        bad = func in HOST_READS
        bad |= func is torch.as_tensor and not isinstance(args[0], torch.Tensor)
        bad |= (func is torch.Tensor.__getitem__ and isinstance(args[1], torch.Tensor)
                and args[1].dtype == torch.bool)
        if bad:
            frames = traceback.extract_stack()[:-1]
            frame = ([f for f in frames if "umetrack_torch" in f.filename] or frames)[-1]
            self.seen.add(f"{getattr(func, '__name__', func)} at {frame.filename}:{frame.lineno}")
        return func(*args, **(kwargs or {}))


def _step_calls(setup):
    model, tracker = setup["tracker"].model, setup["tracker"]
    rig, seq, hand = setup["seqs"]["a"]
    rig_b, seq_b, hand_b = setup["seqs"]["b"]
    obs = seq.map(lambda a: a[0])
    rigs, seqs, hands = _stacked(rig, rig_b), _stacked(seq, seq_b), stack_hand_models([hand, hand_b])
    cfg = tracker.config
    return {
        "frame_known": lambda: port_tracker._track_step(
            model, cfg, rig, obs, tracker.init_state(), hand, 1, True, "plain"),
        "frame_scale_head": lambda: port_tracker._track_step(
            model, cfg, rig, obs, tracker.init_state(), hand, 2, False, "plain_image"),
        "sequence": lambda: port_tracker._sequence_step(
            model, cfg, rig, seq, tracker.init_state(), hand, 1, hand_b, "plain"),
        "sequences_batched": lambda: port_tracker._sequences_batched_step(
            model, cfg, rigs, seqs, tracker.init_state(4), hands, 1, None, "plain"),
    }


@pytest.mark.parametrize("name", ["frame_known", "frame_scale_head", "sequence", "sequences_batched"])
def test_the_captured_steps_make_no_host_round_trip(setup, name):
    call = _step_calls(setup)[name]
    with HostReads() as reads:
        with torch.inference_mode():
            call()
    assert not reads.seen, sorted(reads.seen)


def test_the_host_read_audit_sees_a_host_read():
    with HostReads() as reads:
        x = torch.ones(3)
        bool(x.sum() > 0)
        torch.tensor([1.0, 2.0])
    assert len(reads.seen) == 2


# ---- the public entry points, replayed, against JAX -------------------------------


def _results_close(ours, ref, scales=False):
    v = np.asarray(ref.valid)
    np.testing.assert_array_equal(ours.valid.numpy(), v)
    assert v.any()
    np.testing.assert_allclose(ours.joint_angles.numpy()[v], np.asarray(ref.joint_angles)[v], atol=ANGLE_TOL)
    np.testing.assert_allclose(
        ours.wrist_xfs.numpy()[v][..., :3, 3], np.asarray(ref.wrist_xfs)[v][..., :3, 3], atol=WRIST_TOL_MM)
    if scales:
        np.testing.assert_allclose(
            ours.predicted_scales.numpy()[v], np.asarray(ref.predicted_scales)[v], atol=SCALE_TOL)


@pytest.mark.parametrize("known", [True, False], ids=["known", "scale_head"])
def test_track_frame_replayed_matches_jax(setup, fake_graphs, known):
    tracker, jtracker = setup["tracker"], setup["jtracker"]
    step = tracker.track_frame if known else tracker.track_frame_and_calibrate_scale
    jstep = jtracker.track_frame if known else jtracker.track_frame_and_calibrate_scale
    rig, seq, hand = setup["seqs"]["a"]
    step(rig, seq.map(lambda a: a[0]), tracker.init_state(), hand)  # captured on frame 0 of a
    # replayed on frames 0-1 of b with the carry threaded through
    rig_b, seq_b, hand_b = setup["seqs"]["b"]
    jrig, jseq, jhand = setup["jseqs"]["b"]
    state, jstate = tracker.init_state(), jtracker.init_state()
    for i in range(2):
        res, state = step(rig_b, seq_b.map(lambda a: a[i]), state, hand_b)
        ref, jstate = jstep(jrig, jax.tree_util.tree_map(lambda a: a[i], jseq), jstate, jhand)
        _results_close(res, ref, scales=not known)
    assert len(fake_graphs.graphs) == 1 and fake_graphs.graphs[0].replays == 2
    np.testing.assert_array_equal(state.valid_history.numpy(), np.asarray(jstate.valid_history))


def test_track_sequence_replayed_matches_jax(setup, fake_graphs):
    tracker, jtracker = setup["tracker"], setup["jtracker"]
    tracker.track_sequence(*setup["seqs"]["a"])
    ours, _ = tracker.track_sequence(*setup["seqs"]["b"])
    assert fake_graphs.graphs[0].replays == 1
    ref, _ = jtracker.track_sequence(*setup["jseqs"]["b"])
    _results_close(ours, ref)


def test_track_sequences_batched_replayed_matches_jax(setup, fake_graphs):
    tracker, jtracker = setup["tracker"], setup["jtracker"]

    def stacked(order):
        trees = [setup["seqs"][name] for name in order]
        return (_stacked(*[t[0] for t in trees]), _stacked(*[t[1] for t in trees]),
                stack_hand_models([t[2] for t in trees]))

    tracker.track_sequences_batched(*stacked("ab"))
    ours, _ = tracker.track_sequences_batched(*stacked("ba"))
    assert fake_graphs.graphs[0].replays == 1
    jtrees = [setup["jseqs"][name] for name in "ba"]
    jstack = lambda i: jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[t[i] for t in jtrees])  # noqa: E731
    jinit = JTrackState(
        temporal=JTemporalState.zeros(4, jtracker.model.config), valid_history=jnp.zeros((4,), bool),
    )
    ref, _ = jbatched(jtracker.model, JTrackerConfig(sampler="pallas_pool"), jtracker.variables,
                      jstack(0), jstack(1), jinit, jstack(2))
    assert ours.joint_angles.shape == (T_FRAMES, 2, 2, 22)
    _results_close(ours, ref)
