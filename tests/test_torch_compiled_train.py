"""The compiled steps beyond the tracker's serving entry points, on the CPU:
the train steps (``parallel/train.py``, ``parallel/resident.py``) with the
capturable ``ClippedAdamW`` (``parallel/optim.py``), the resident eval and
diagnosis, the calibrations (``tracker/tracker.py``) and the batched evals
(``parallel/eval.py``).  The optimizer's device schedule against optax; the
steps making no host round trip; the training key; the window gathered at
a tensor start against JAX; and, through a CPU stand-in for CUDA graphs,
replayed steps against the eager port and against the JAX package (small
config, f32, the bounds of ``tests/test_torch_train.py`` and of the
tracker tests)."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from umetrack_tpu.models import make_model as jmake_model
from umetrack_tpu.models.config import ModelConfig as JModelConfig
from umetrack_tpu.parallel import resident as jres
from umetrack_tpu.parallel import train as jtrain
from umetrack_tpu.tracker.tracker import calibrate_sequences_batched as jcalibrate_batched
from umetrack_tpu.tracker.tracker import predict_scales_sequence as jpredict_scales
from umetrack_tpu.tracker.types import TrackState as JTrackState
from umetrack_tpu.models.umetrack import TemporalState as JTemporalState
from umetrack_tpu.tracker import TrackerConfig as JTrackerConfig
from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict, stack_hand_models
from umetrack_torch.models import ModelConfig, UmeTrackNet, from_flax_variables
from umetrack_torch.models.convert import to_flax_variables
from umetrack_torch.parallel import eval as peval
from umetrack_torch.parallel import optim, resident
from umetrack_torch.parallel import train as ptrain
from umetrack_torch.parallel.train import LossWeights, create_train_state
from umetrack_torch.tracker import compiled
from umetrack_torch.tracker import tracker as port_tracker
from test_torch_compiled import SCALE_TOL, FakeGraphs, HostReads, _stacked, setup  # noqa: F401
from test_torch_resident import SCALE_LOSS_RTOL, WINDOW, arrays, corpora, variables, _port_model  # noqa: F401
from test_torch_train import (
    FIRST_LAYERS_REL_L2,
    GRAD_REL_L2,
    LOSS_RTOL,
    OPTIM_ATOL,
    STATS_TOL,
    _frame_batches,
    _temporal_batches,
)
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

CPU = torch.device("cpu")
# The window's gradient of the stem and the first two stages is summed over
# every pixel of K frames through train-mode BatchNorm's backward (see
# tests/test_torch_train.py): at this test's windows the two packages' f32
# roundings part by up to 3.5e-3 relative L2 in ``stage1_block0``, so these
# layers are held to the first layers' 1e-2; every other leaf and the whole
# gradient to 1e-3.
JAX_WINDOW = 2
# The whole gradient against JAX's from the same weights: 1e-3 relative L2
# while the weights are the initial ones (the captured call and the first
# replay: a warmup's first learning rate is 0); once Adam has moved them,
# the small config's gradient is ill-conditioned in f32 (1.48e-3 measured at
# the third replay), held to the train tests' 1e-2 of the first layers.
MOVED_GRAD_REL_L2 = FIRST_LAYERS_REL_L2


# ---- the optimizer's schedule on the device -------------------------------------


@pytest.mark.parametrize("args", [(0.0, 1e-2, 2, 5, 1e-4), (3e-4, 1e-3, 0, 7, 0.0)],
                         ids=["warmup", "no_warmup"])
def test_device_schedule_matches_optax_at_every_count(args):
    """The schedule's tensor form (what a captured update evaluates from
    the device count) against optax and its own Python form, at every
    count through the end of the decay and past it."""
    ref = optax.warmup_cosine_decay_schedule(*args)
    ours = optim.warmup_cosine_decay_schedule(*args)
    for count in range(args[3] + 3):
        on_device = ours(torch.tensor(float(count), dtype=torch.float64))
        assert on_device.dtype == torch.float64 and on_device.dim() == 0
        np.testing.assert_allclose(float(on_device), float(ref(count)), rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(float(on_device), ours(count), rtol=1e-12, atol=1e-15)
    assert float(optim.Constant(0.25)(torch.zeros((), dtype=torch.float64))) == 0.25


# ---- no host round trip -----------------------------------------------------------


def _train_model():
    return UmeTrackNet(ModelConfig(**_SMALL))


_SMALL = dict(start_planes=8, backbone_blocks=(1, 1, 1, 1), n_image_feature_channels=12,
              n_memory_channels=6)


def _prepared(model, schedule=1e-3):
    opt = optim.ClippedAdamW(model.parameters(), schedule, 1e-5, max_grad_norm=1.0)
    opt.prepare()
    model.train()
    return opt


def _step_calls(setup, corpora):
    """The device work of each compiled step, called directly."""
    tracker = setup["tracker"]
    model, cfg = tracker.model, tracker.config
    rig, seq, hand = setup["seqs"]["a"]
    rig_b, seq_b, hand_b = setup["seqs"]["b"]
    rigs, seqs, hands = _stacked(rig, rig_b), _stacked(seq, seq_b), stack_hand_models([hand, hand_b])
    generic = from_dict(load_generic_hand_dict())
    corpus = corpora[1]
    idx, t0 = torch.tensor([1, 0]), torch.tensor(2)
    sched = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 6)

    def train(fn, batch):
        def call():
            net = _train_model()
            opt = _prepared(net, sched)
            return lambda: fn(net, batch, opt, LossWeights(accel=100.0))
        return call

    def resident_step():
        net = _train_model()
        opt = _prepared(net, sched)
        gen = torch.Generator().manual_seed(0)
        return lambda: resident._resident_update(net, idx, t0, corpus, opt, LossWeights(), WINDOW, gen)

    def eval_mode(fn, **kw):
        def call():
            net = _train_model().eval()
            return lambda: fn(net, idx, t0, corpus, WINDOW, **kw)
        return call

    return {
        "train_step": train(ptrain._train_update, _frame_batches()[1]),
        "temporal_train_step": train(ptrain._temporal_update, _temporal_batches()[1]),
        "resident_train_step_augmented": resident_step,
        "resident_eval_mpjpe": eval_mode(resident._eval_mpjpe),
        "resident_diagnose": eval_mode(resident._diagnose),
        "calibrate_sequences_batched": lambda: lambda: port_tracker._calibrate_sequences_batched_step(
            model, cfg, rigs, seqs, tracker.init_state(4), hands, 6, 2, "plain"),
        "predict_scales_sequence": lambda: lambda: port_tracker._predict_scales_step(
            model, cfg, rig, seq, tracker.init_state(), hand, 2, "plain"),
        "calibrate_sequence": lambda: lambda: port_tracker._calibrate_step(
            model, cfg, rig, seq, tracker.init_state(), hand, 3, "plain"),
        "eval_sequences_batched": lambda: lambda: peval._eval_batched_step(
            model, cfg, rigs, seqs, tracker.init_state(4), hands, None, None, 1, "plain"),
        "eval_sequences_unknown_batched": lambda: lambda: peval._eval_unknown_step(
            model, cfg, rigs, seqs, hands, generic, 6, 1, "plain"),
    }


STEPS = ["train_step", "temporal_train_step", "resident_train_step_augmented", "resident_eval_mpjpe",
         "resident_diagnose", "calibrate_sequences_batched", "predict_scales_sequence",
         "calibrate_sequence", "eval_sequences_batched", "eval_sequences_unknown_batched"]


@pytest.mark.parametrize("name", STEPS)
def test_the_captured_steps_make_no_host_round_trip(setup, corpora, name):
    """Each step's device work, with autograd and the optimizer's update
    where it trains, reads no value on the host and copies nothing from
    it (what a CUDA graph cannot capture)."""
    call = _step_calls(setup, corpora)[name]()  # built outside the audit
    with HostReads() as reads:
        if name in STEPS[:3]:
            call()
        else:
            with torch.inference_mode():
                call()
    assert not reads.seen, sorted(reads.seen)


# ---- the training key ---------------------------------------------------------------


def _train_key(model, opt, batch, weights=LossWeights()):
    return ptrain._TRAIN.key(model, dict(batch=batch), dict(optimizer=opt, weights=weights), CPU)


@pytest.mark.parametrize("change", ["moment", "gradient", "count", "schedule", "optimizer",
                                    "loss_weights", "gt_scales", "mode"])
def test_train_key_changes_with_what_a_capture_bakes_in(change):
    model = _train_model()
    opt = _prepared(model)
    batch = _frame_batches()[1]
    base = _train_key(model, opt, batch)
    other = ptrain.synthetic_train_batch(5, batch.gt_scales.shape[0], from_dict(load_generic_hand_dict()), "cpu")
    assert _train_key(model, opt, other) == base  # other values, the same key
    p = next(model.parameters())
    if change == "moment":
        opt.state[p]["exp_avg"] = opt.state[p]["exp_avg"].clone()
    elif change == "gradient":  # a gradient set to None is made again, here at another address
        old = p.grad  # noqa: F841  (kept alive: a freed block could be handed out again)
        p.grad = None
        opt.prepare()
    elif change == "count":
        opt.step_count = opt.step_count.clone()
    elif change == "schedule":
        opt.schedule = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 6)
    elif change == "optimizer":
        opt = _prepared(model)
    elif change == "loss_weights":
        assert _train_key(model, opt, batch, LossWeights(accel=1.0)) != base
        return
    elif change == "gt_scales":
        batch = dataclasses.replace(batch, gt_scales=None)
    else:
        model.eval()
    assert _train_key(model, opt, batch) != base


def _resident_key(model, opt, corpus, t0, window=WINDOW, generator=None, idx=(1, 0)):
    return resident._RESIDENT.key(
        model, dict(seq_idx=torch.tensor(idx), t0=torch.tensor(t0)),
        dict(optimizer=opt, weights=LossWeights(), window=window, generator=generator), CPU,
        dict(corpus=corpus))


def test_resident_key_is_one_for_every_window_start(corpora):
    """The window start and the sequences are device inputs: one key for
    all of them; the window, the augmentation and the corpus's storage are
    in it."""
    corpus = corpora[1]
    model = _train_model()
    opt = _prepared(model)
    base = _resident_key(model, opt, corpus, 0)
    assert all(_resident_key(model, opt, corpus, t0, idx=(2, 1)) == base for t0 in range(4))
    assert _resident_key(model, opt, corpus, 0, window=2) != base
    assert _resident_key(model, opt, corpus, 0, generator=torch.Generator()) != base
    moved = dataclasses.replace(corpus, images=corpus.images.clone())
    assert _resident_key(model, opt, moved, 0) != base


# ---- the window at a tensor start ------------------------------------------------------


@pytest.mark.parametrize("t0", [0, 1, 3, 5], ids=lambda t: f"t0={t}")
def test_gather_window_at_a_tensor_start_matches_jax(corpora, t0):
    """Every field of a window gathered at a device ``t0``, against JAX's
    ``dynamic_slice`` (which clamps a start past ``T - window``), bit for
    bit through bf16."""
    jcorpus, corpus = corpora
    idx = [2, 0]
    jb = jres.gather_window(jcorpus, jnp.asarray(idx, jnp.int32), jnp.asarray(t0, jnp.int32), WINDOW)
    b = resident.gather_window(corpus, torch.tensor(idx), torch.tensor(t0), WINDOW)
    pairs = [
        (jb.frames.images, b.frames.images), (jb.frames.intrinsics, b.frames.intrinsics),
        (jb.frames.extrinsics, b.frames.extrinsics), (jb.frames.n_views, b.frames.n_views),
        (jb.frames.hand_idx, b.frames.hand_idx), (jb.frames.use_memory, b.frames.use_memory),
        (jb.gt_joint_angles, b.gt_joint_angles), (jb.gt_wrist_world, b.gt_wrist_world),
        (jb.gt_scales, b.gt_scales), (jb.valid, b.valid),
        (jb.skeleton.joint_rotation_axes, b.skeleton.joint_rotation_axes),
        (jb.hand.landmark_rest_positions, b.hand.landmark_rest_positions),
    ]
    for a, c in pairs:
        a = np.asarray(a)
        assert a.shape == tuple(c.shape)
        np.testing.assert_array_equal(a.astype(np.float32), c.numpy().astype(np.float32))


# ---- replays through a CPU stand-in ------------------------------------------------


def _state_tensors(model, opt):
    out = list(model.parameters()) + list(model.buffers()) + [opt.step_count, opt.global_norm]
    for p in model.parameters():
        out += [p.grad, *opt.state[p].values()]
    return [t for t in out if t is not None]


class TrainFakeGraphs(FakeGraphs):
    """FakeGraphs for training steps.  A CUDA capture records kernels and
    runs none, so the stand-in undoes its capture run: the models'
    tensors, gradients and optimizer state and the generators are left as
    they were before it."""

    def __init__(self, *states):
        super().__init__()
        self.states = states  # (model, optimizer) pairs

    def capture(self, run, device, *generators):
        tensors = [t for model, opt in self.states for t in _state_tensors(model, opt)]
        saved = [t.detach().clone() for t in tensors]
        generator_states = [g.get_state() for g in generators]
        out = super().capture(run, device)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        for g, s in zip(generators, generator_states):
            g.set_state(s)
        return out


@pytest.fixture
def train_fakes(monkeypatch):
    def install(*states):
        compiled.release()
        fake = TrainFakeGraphs(*states)
        monkeypatch.setattr(compiled, "GRAPHS", fake)
        return fake
    yield install
    compiled.release()


@pytest.mark.parametrize("kind", ["train_step", "temporal_train_step", "resident_augmented"])
def test_replayed_train_steps_equal_eager_steps(train_fakes, corpora, kind):
    """Three steps captured once and replayed against the same three steps
    run eagerly from identical copies of the model, optimizer and
    generator: metrics, parameters, running stats, moments and counts bit
    for bit, one graph for all of them."""
    corpus = corpora[1]
    sched = optim.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 6)
    models = [_train_model(), None]
    models[1] = copy.deepcopy(models[0])
    states = [create_train_state(m, optim.ClippedAdamW(m.parameters(), sched, 1e-5)) for m in models]
    gens = [torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)]
    fake = train_fakes(*[(s.model, s.optimizer) for s in states])
    if kind == "train_step":
        base = _frame_batches()[1]
        draws = [dataclasses.replace(base, gt_joint_angles=base.gt_joint_angles * (1 + 0.1 * i)) for i in range(3)]
        step, calls = ptrain._TRAIN, [(dict(batch=b), None, dict(weights=LossWeights())) for b in draws]
    elif kind == "temporal_train_step":
        base = _temporal_batches()[1]
        draws = [dataclasses.replace(base, gt_joint_angles=base.gt_joint_angles * (1 + 0.1 * i)) for i in range(3)]
        step, calls = ptrain._TEMPORAL, [(dict(batch=b), None, dict(weights=LossWeights(accel=100.0)))
                                         for b in draws]
    else:
        step = resident._RESIDENT
        calls = [(dict(seq_idx=torch.tensor(idx), t0=torch.tensor(t0)), dict(corpus=corpus),
                  dict(weights=LossWeights(), window=WINDOW)) for idx, t0 in (([0, 2], 0), ([1, 0], 3), ([2, 1], 1))]
    outs = []
    for state, gen, eager in zip(states, gens, (False, True)):
        outs.append([])
        for inputs, res, static in calls:
            extra = dict(generator=gen) if kind == "resident_augmented" else {}
            outs[-1].append(ptrain.run_step(step, state, inputs, res, eager=eager, **static, **extra))
    assert len(fake.graphs) == 1 and fake.graphs[0].replays == 2
    for got, want in zip(*outs):
        assert all(torch.equal(got[k], want[k]) for k in want)
    (a, b) = states
    assert a.step == b.step == 3 and a.optimizer.count == b.optimizer.count == 3
    assert all(torch.equal(x, y) for x, y in zip(_state_tensors(a.model, a.optimizer),
                                                   _state_tensors(b.model, b.optimizer)))
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_a_train_step_after_an_eval_replays_its_graph(train_fakes, corpora):
    """``resident_eval_mpjpe`` leaves the model in eval mode; the next
    train step sets train mode before its key is read, so it replays the
    graph the first step captured instead of keying another."""
    corpus = corpora[1]
    model = _train_model()
    state = create_train_state(model, optim.ClippedAdamW(model.parameters(), 1e-4, 1e-5))
    fake = train_fakes((model, state.optimizer))
    idx = torch.tensor([0, 2])
    for t0 in (0, 3):
        resident.resident_train_step(state, corpus, idx, torch.tensor(t0), LossWeights(), WINDOW)
        resident.resident_eval_mpjpe(model, corpus, idx, 0, WINDOW)
        assert not model.training
    steps = [c.step for c in compiled.cached()]
    assert steps == ["_resident_update", "_eval_mpjpe"], steps
    assert [g.replays for g in fake.graphs] == [1, 1]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_replayed_resident_steps_match_jax(train_fakes, corpora, variables):
    """A captured resident step then three replays at other sequences and
    window starts, under a warmup-cosine schedule; before each, the JAX
    step's loss and gradients from the port's current weights: metrics
    (1e-5; the scale head's small term 5e-4, as in test_torch_resident),
    the whole gradient after the clip (see MOVED_GRAD_REL_L2) and the
    running stats after the step; and optax's AdamW on the port's clipped
    gradients against the port's parameters (OPTIM_ATOL)."""
    jcorpus, corpus = corpora
    model = _port_model(variables)
    sched_args = (0.0, 1e-4, 2, 6, 1e-6)
    opt = optim.ClippedAdamW(model.parameters(), optim.warmup_cosine_decay_schedule(*sched_args), 1e-5)
    state = create_train_state(model, opt)
    fake = train_fakes((model, opt))
    jmodel = jmake_model(JModelConfig(**_SMALL))
    clip = optax.clip_by_global_norm(1.0)
    adamw = optax.adamw(optax.warmup_cosine_decay_schedule(*sched_args), weight_decay=1e-5)
    tparams = {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()}
    tstate = adamw.init(tparams)
    loss_grad = jax.value_and_grad(
        lambda p, s, b: jtrain.temporal_loss_fn(jmodel, p, s, b, jtrain.LossWeights()), has_aux=True)

    @jax.jit
    def jstep(params, stats, batch):  # the JAX loss, running stats and clipped gradients
        (_, (new_stats, metrics)), grads = loss_grad(params, stats, batch)
        return new_stats, metrics, clip.update(grads, clip.init(grads))[0]

    @jax.jit
    def jadamw(grads, opt_state, params):
        updates, opt_state = adamw.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for step, (idx, t0) in enumerate((([0, 2], 0), ([1, 0], 3), ([2, 1], 1), ([0, 1], 2))):
        jv = jax.tree_util.tree_map(jnp.asarray, to_flax_variables(model.state_dict()))
        jbatch = jres.gather_window(jcorpus, jnp.asarray(idx, jnp.int32), jnp.asarray(t0, jnp.int32), JAX_WINDOW)
        stats_j, metrics_j, grads_j = jstep(jv["params"], jv["batch_stats"], jbatch)
        metrics = resident.resident_train_step(state, corpus, torch.tensor(idx), torch.tensor(t0),
                                               LossWeights(), JAX_WINDOW)
        for key, value in metrics_j.items():
            rtol = SCALE_LOSS_RTOL if key == "scale_loss" else LOSS_RTOL
            np.testing.assert_allclose(float(metrics[key]), float(value), rtol=rtol, atol=1e-7, err_msg=key)
        to_np = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
        want = from_flax_variables({"params": to_np(grads_j), "batch_stats": to_np(stats_j)}, model.config)
        g = np.concatenate([p.grad.numpy().ravel() for _, p in model.named_parameters()])
        gj = np.concatenate([want[n].numpy().ravel() for n, _ in model.named_parameters()])
        bound = GRAD_REL_L2 if step < 2 else MOVED_GRAD_REL_L2
        assert _rel_l2(g, gj) <= bound, (step, _rel_l2(g, gj), bound)
        for name, buf in model.named_buffers():
            if "running" in name:
                np.testing.assert_allclose(buf.numpy(), want[name].numpy(), rtol=STATS_TOL, atol=STATS_TOL)
        grads = {n: jnp.asarray(p.grad.numpy()) for n, p in model.named_parameters()}
        tparams, tstate = jadamw(grads, tstate, tparams)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(tparams[name]), rtol=0,
                                       atol=OPTIM_ATOL, err_msg=name)
    assert len(fake.graphs) == 1 and fake.graphs[0].replays == 3


@pytest.fixture
def fake_graphs(monkeypatch):
    compiled.release()
    fake = FakeGraphs()
    monkeypatch.setattr(compiled, "GRAPHS", fake)
    yield fake
    compiled.release()


def _jinit(rows):
    return JTrackState(temporal=JTemporalState.zeros(rows, JModelConfig(**_SMALL)),
                       valid_history=jnp.zeros((rows,), bool))


def test_calibrations_replayed_match_jax(setup, fake_graphs):
    """The three calibrations captured on sequence a (or a, b) and
    replayed on b (or b, a), against the JAX package at the tracker's scale
    bound: ``predict_scales`` per frame, ``calibrate_sequence`` as the mean
    of JAX's first valid predictions, ``calibrate_sequences_batched``."""
    tracker, jtracker = setup["tracker"], setup["jtracker"]
    n_samples = 3
    tracker.predict_scales(*setup["seqs"]["a"])
    tracker.calibrate_sequence(*setup["seqs"]["a"], n_samples)
    scales, valid, _ = tracker.predict_scales(*setup["seqs"]["b"])
    calibrated = tracker.calibrate_sequence(*setup["seqs"]["b"], n_samples)
    jscales, jvalid, _ = jpredict_scales(jtracker.model, JTrackerConfig(sampler="pallas_pool"), jtracker.variables,
                                         *setup["jseqs"]["b"][:2], _jinit(2), setup["jseqs"]["b"][2])
    jscales, jvalid = np.asarray(jscales), np.asarray(jvalid)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    assert jvalid.any()
    np.testing.assert_allclose(scales.numpy()[jvalid], jscales[jvalid], atol=SCALE_TOL)
    first = jscales.reshape(-1)[jvalid.reshape(-1)][:n_samples]
    np.testing.assert_allclose(float(calibrated), first.mean(), atol=SCALE_TOL)

    def batched(order):
        trees = [setup["seqs"][name] for name in order]
        return (_stacked(*[t[0] for t in trees]), _stacked(*[t[1] for t in trees]),
                stack_hand_models([t[2] for t in trees]))

    for order in ("ab", "ba"):  # captured, then replayed
        rigs, seqs, hands = batched(order)
        ours = port_tracker.calibrate_sequences_batched(tracker.model, tracker.config, rigs, seqs,
                                                        tracker.init_state(4), hands, n_samples, device="cpu")
    jrigs, jseqs, jhands = [jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[setup["jseqs"][n][i] for n in "ba"])
                            for i in range(3)]
    ref = jcalibrate_batched(jtracker.model, JTrackerConfig(sampler="pallas_pool"), jtracker.variables,
                             jrigs, jseqs, _jinit(4), jhands, n_samples)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=SCALE_TOL)
    assert len(fake_graphs.graphs) == 3 and all(g.replays == 1 for g in fake_graphs.graphs)
