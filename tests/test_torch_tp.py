"""The tensor-parallel ``model`` axis of the port (``parallel/mesh.py``,
``parallel/collectives.py``, ``models/backbone.py``'s sharded ``Conv`` and
``Dense``) against the JAX package's ``parallel/mesh.py``.

In this process: the leaves that ``param_sharding`` splits, by
``convert.py``'s names, equal the JAX rule's at ``ModelConfig()`` and at the
small config, with model 2 and 4; the (data, model) rank layouts equal
JAX's ``reshape``.  Then one spawn of four gloo processes on the CPU, a
(data 2, model 2) mesh (this file run as ``--worker``, with a timeout):
``train_step`` and ``temporal_train_step`` with the clip engaged, both
batched eval protocols, and the train app's ``main`` with ``{"mesh":
{"model_axis": 2}}`` for 2 steps, which writes a checkpoint, and
``_model_scan`` on each rank's rows of crops prepared once with no group.
Their results are held against the JAX package on a (2, 2) mesh of its
virtual CPU devices, against the port in one process with no group, and
across the ranks (the replicated parameters equal bit for bit over the
model ranks)."""
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from umetrack_torch.kinematics.hand import from_dict, load_generic_hand_dict, stack_hand_models  # noqa: E402
from umetrack_torch.models import FrameInputs, ModelConfig, TemporalState, UmeTrackNet  # noqa: E402
from umetrack_torch.models.convert import from_flax_variables, to_flax_variables  # noqa: E402
from umetrack_torch.parallel import distributed, eval as peval  # noqa: E402
from umetrack_torch.parallel.mesh import (  # noqa: E402
    Mesh, block, full_state_dict, make_mesh, mesh_shape, param_sharding, shard_batch, shard_variables)
from umetrack_torch.parallel.optim import ClippedAdamW  # noqa: E402
from umetrack_torch.parallel.train import (  # noqa: E402
    TemporalTrainBatch,
    create_train_state,
    init_train_model,
    synthetic_train_batch,
    temporal_train_step,
    train_step,
)
from umetrack_torch.tracker import TrackerConfig, sequence_landmarks  # noqa: E402
from umetrack_torch.tracker import tracker  # noqa: E402
from umetrack_torch.tracker.types import CameraRig, FrameObservation, TrackState  # noqa: E402
from umetrack_torch.utils.synthetic import make_labels_dict, our_sequence  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401  (autouse: two CPU threads)

WORLD, DATA, MODEL = 4, 2, 2
# start_planes 16: 20 leaves shard at the default rule (8 would leave most
# of the backbone under min_shard_size)
SMALL = dict(start_planes=16, backbone_blocks=(1, 1, 1, 1),
             n_image_feature_channels=12, n_memory_channels=6)
B, K = 6, 4  # train: 3 rows a data index
# The batches' seed: the comparison must measure the sharding, not a kink
# of the step that f32 rounding crosses (Adam's first update, lr *
# g / (|g| + eps) after the clip, magnifies it).  With the seeded weights of
# flax's draw, random noise of one ulp (1e-7 relative) on the images moves
# the one-process updates by 3.3 x the bound (train_step) and 63 x
# (temporal) at seed 3; over seeds 0-12, 1 moves them least: gradients
# 0.012 x / 0.025 x, updates 0.66 x / 0.64 x the bounds (at the old draw
# seed 3 read 0.64 x / 1.6 x).
BATCH_SEED = 1
VALID = np.array([1, 1, 1, 1, 0, 0], bool)
VALID_T = np.ones((B, K), bool)
VALID_T[1, 3] = VALID_T[4] = VALID_T[5, 2:] = False
LR, WD = 1e-3, 1e-5
CLIP = 0.05  # below every step's gradient norm here: the clip engages
S, T = 4, 4  # eval: 2 sequences a data index
N_CALIBRATION = 6
APP_STEPS, APP_BATCH, APP_WINDOW = 2, 4, 2
# tests/test_torch_train.py's bounds
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
FIRST_LAYERS_REL_L2 = 1e-2
FIRST_LAYERS = ("backbone.stem_", "backbone.stage0_block0.")
ZERO_GRAD_LEAVES = ("backbone.stem_conv.bias", "fusion.conv0.bias", "fusion.conv1.bias")
ZERO_GRAD_NOISE = 1e-5
STATS_TOL = 1e-5
NORM_RTOL = 1e-5
EVAL_MM_TOL, EVAL_RTOL = 1e-3, 1e-4  # tests/test_parallel.py's sharded-eval bounds
JAX_EVAL_MM_TOL = 0.1  # port against JAX, tests/test_torch_parallel_eval.py's bound
SCALE_TOL = 2e-3
TIMEOUT_S = 300
STEPS = ("train_step", "temporal_train_step")


def _stack(trees, cls):
    return cls(**{k: torch.stack([getattr(tr, k) for tr in trees]) for k in trees[0].__dataclass_fields__})


def eval_labels():
    return [make_labels_dict(T, rng_seed=20 + i, render=False, device="cpu") for i in range(S)]


def eval_inputs():
    parts = [our_sequence(labels, images, "cpu") for labels, images in eval_labels()]
    return (_stack([p[0] for p in parts], CameraRig), _stack([p[1] for p in parts], FrameObservation),
            stack_hand_models([p[2] for p in parts]))


def train_batches():
    """A single-frame batch and a K-frame window of B rows (the window from
    K single-frame draws, the crop cameras drifting 1 cm a frame), with the
    valid masks above: the data indices hold different numbers of valid
    rows."""
    hand = from_dict(load_generic_hand_dict())
    frame = dataclasses.replace(synthetic_train_batch(BATCH_SEED, B, hand, device="cpu"),
                                valid=torch.from_numpy(VALID))
    draws = [synthetic_train_batch(BATCH_SEED + 10 + k, B, hand, device="cpu") for k in range(K)]
    f0 = draws[0].frame
    extr = f0.extrinsics[:, None].repeat(1, K, 1, 1, 1)
    extr[..., :3, 3] += 0.01 * torch.arange(K, dtype=torch.float32)[None, :, None, None]
    window = TemporalTrainBatch(
        frames=FrameInputs(
            images=torch.stack([d.frame.images for d in draws], dim=1),
            intrinsics=f0.intrinsics[:, None].repeat(1, K, 1, 1, 1),
            extrinsics=extr,
            n_views=f0.n_views[:, None].repeat(1, K),
            hand_idx=f0.hand_idx[:, None].repeat(1, K),
            use_memory=(torch.arange(K) > 0).expand(B, K).contiguous(),
        ),
        skeleton=draws[0].skeleton,
        gt_joint_angles=torch.stack([d.gt_joint_angles for d in draws], dim=1),
        gt_wrist_world=torch.stack([d.gt_wrist_world for d in draws], dim=1),
        hand=draws[0].hand, gt_scales=draws[0].gt_scales, valid=torch.from_numpy(VALID_T),
    )
    return {"train_step": (train_step, frame), "temporal_train_step": (temporal_train_step, window)}


def forward_batch():
    hand = from_dict(load_generic_hand_dict())
    return synthetic_train_batch(7, 2, hand, device="cpu")


def forward(model):
    """The eval-mode known-skeleton outputs on :func:`forward_batch`."""
    batch = forward_batch()
    model.eval()
    with torch.no_grad():
        out, _ = model.known_skeleton(batch.frame, batch.skeleton,
                                      TemporalState.zeros(2, model.config, device="cpu"))
    return {k: getattr(out, k).clone() for k in ("joint_angles", "wrist_xfs", "landmark_uncertainty_sigmas")}


def _full_grads(model, mesh):
    from umetrack_torch.parallel.collectives import gather_blocks

    grads = {}
    for name, p in model.named_parameters():
        g = p.grad.detach()
        if getattr(p, "partition_dim", None) is not None:
            g = gather_blocks(g, 0, mesh.model_group)
        grads[name] = g.clone()
    return grads


def run_steps(mesh):
    """{step name: (metrics, gradients, weights after, running stats, global
    norm)} after one step of each kind from seeded weights on this rank's
    block of the batch, gathered whole."""
    out = {}
    for name, (step_fn, batch) in train_batches().items():
        model = init_train_model(ModelConfig(**SMALL), seed=0, device="cpu")
        shard_variables(model, mesh)
        opt = ClippedAdamW(model.parameters(), LR, WD, max_grad_norm=CLIP, mesh=mesh)
        metrics = step_fn(create_train_state(model, opt), shard_batch(batch, mesh))
        weights = full_state_dict(model, mesh)
        out[name] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            grads=_full_grads(model, mesh),
            weights={k: v.clone() for k, v in weights.items() if "running" not in k and "num_batches" not in k},
            stats={k: v.clone() for k, v in weights.items() if "running" in k},
            norm=float(opt.global_norm),
        )
    return out


def run_eval(mesh):
    """Both batched protocols on this rank's block of the S sequences."""
    rigs, seqs, hands = eval_inputs()
    model = init_train_model(ModelConfig(**SMALL), seed=0, device="cpu").eval()
    shard_variables(model, mesh)
    state = peval.make_batched_state(model, S, "cpu")
    rigs, seqs, state, hands = peval.shard_eval_inputs(mesh, rigs, seqs, state, hands)
    known = peval.eval_sequences_batched(model, TrackerConfig(), rigs, seqs, state, hands, device="cpu")
    unknown = peval.eval_sequences_unknown_batched(
        model, TrackerConfig(), rigs, seqs, hands, from_dict(load_generic_hand_dict()),
        n_calibration_samples=N_CALIBRATION, device="cpu")
    return {"known": [x.clone() for x in known], "unknown": [x.clone() for x in unknown]}


def prepare_crops(path):
    """The eval sequences' crop sets and crop images, prepared once with no
    group (``_prepare_sequences_merged``, leaves ``[T, 2S, ...]``), saved to
    ``path`` for every rank."""
    rigs, seqs, hands = eval_inputs()
    with torch.inference_mode():
        crop_sets, crop_images = tracker._prepare_sequences_merged(TrackerConfig(), rigs, seqs, hands, 1, "plain")
    torch.save(dict(crop_sets=crop_sets, crop_images=crop_images,
                    skeleton=tracker._skeleton_inputs(hands, repeat=2), hand_idx=torch.arange(2).repeat(S)), path)


def run_same_crops(mesh, path):
    """``_model_scan`` of the seeded model on this data index's rows of the
    crops :func:`prepare_crops` saved: (first sequence, angles, wrists mm,
    valid), leaves ``[T, rows, ...]``."""
    crops = torch.load(path, weights_only=False)
    model = init_train_model(ModelConfig(**SMALL), seed=0, device="cpu").eval()
    shard_variables(model, mesh)
    rows = block(2 * S, mesh)
    with torch.inference_mode():
        res, _ = tracker._model_scan(
            model, TrackerConfig(), crops["crop_sets"].map(lambda a: a[:, rows]), crops["crop_images"][:, rows],
            TrackState.init(model.config, rows.stop - rows.start), crops["skeleton"].map(lambda a: a[rows]),
            crops["hand_idx"][rows])
    return rows.start // 2, res.joint_angles.clone(), res.wrist_xfs.clone(), res.valid.clone()


def run_collectives(mesh):
    """The model axis's collectives on small tensors: the gather's values and
    its backward (this rank's slice, nothing summed), the copy's backward
    (summed over the model group), a bf16 gather exact."""
    from umetrack_torch.parallel.collectives import copy_to_model, gather_from_model

    i, g = mesh.model_index, mesh.model_group
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * mesh.rank
    x.requires_grad_(True)
    w = torch.arange(2 * 3 * MODEL, dtype=torch.float32).reshape(2, 3 * MODEL)
    y = gather_from_model(copy_to_model(x, g), 1, g)
    (y * w).sum().backward()
    bf = gather_from_model((torch.arange(4) + 0.5 * mesh.rank).to(torch.bfloat16) / 3, 0, g)
    return {"y": y.detach(), "x_grad": x.grad, "index": i, "bf16": bf}


def run_app(mesh, out_dir):
    """The train app's ``main`` in the caller's group, the config's
    ``mesh.model_axis`` 2, 2 steps on synthetic 120 x 160 batches; then the
    trained (sharded) model's forward and its gathered weights."""
    from umetrack_torch.apps import train as app
    from umetrack_torch.config import Config, MeshConfig, to_json

    cfg_path = os.path.join(out_dir, "tp.json")
    if mesh.rank == 0:
        to_json(Config(model=ModelConfig(**SMALL), mesh=MeshConfig(model_axis=MODEL)), cfg_path)
    torch.distributed.barrier()
    state, history = app.main([
        "--config", cfg_path, "--synthetic", "--steps", str(APP_STEPS), "--batch-size", str(APP_BATCH),
        "--window", str(APP_WINDOW), "--device", "cpu", "--checkpoint-dir", os.path.join(out_dir, "ckpt")])
    app_mesh = state.model.mesh
    return {"history": history, "mesh": app_mesh.shape, "forward": forward(state.model),
            "weights": full_state_dict(state.model, app_mesh),
            "sharded": sorted(n for n, p in state.model.named_parameters()
                              if getattr(p, "partition_dim", None) is not None)}


def worker(rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    distributed.initialize(f"localhost:{port}", WORLD, rank, device="cpu")
    try:
        mesh = make_mesh(model_axis=MODEL)
        groups = [torch.distributed.get_process_group_ranks(g) for g in (mesh.data_group, mesh.model_group)]
        result = {
            "mesh": (mesh.shape, mesh.data_index, mesh.model_index, groups),
            "collectives": run_collectives(mesh),
            "steps": run_steps(mesh),
            "eval": run_eval(mesh),
            "same_crops": run_same_crops(mesh, os.path.join(out_dir, "crops.pt")),
            "app": run_app(mesh, out_dir),
        }
    finally:
        distributed.finalize()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


# ---- in this process ------------------------------------------------------------------------------


def _jax_sharded_names(config, model):
    """The torch names (through ``convert.py``) and the JAX shapes of the
    leaves the JAX rule shards on a (1, model) mesh of virtual devices."""
    import jax
    from umetrack_tpu.models import init_model
    from umetrack_tpu.models.config import ModelConfig as JModelConfig
    from umetrack_tpu.parallel.mesh import make_mesh as jmake_mesh, param_sharding as jparam_sharding

    shapes = jax.eval_shape(lambda key: init_model(key, JModelConfig(**config))[1], jax.random.PRNGKey(0))
    rule = jparam_sharding(jmake_mesh(jax.devices()[:model], model_axis=model))
    last_axis = {}

    def mark(path, leaf):  # ones where sharded, zeros elsewhere
        sharded = any(axis is not None for axis in rule(path, leaf).spec)
        if sharded:
            last_axis[path] = leaf.shape[-1]
        return np.full(leaf.shape, float(sharded), np.float32)

    marked = jax.tree_util.tree_map_with_path(mark, shapes)
    torch_leaves = from_flax_variables(marked, ModelConfig(**config))
    names = {k for k, v in torch_leaves.items() if v.dtype == torch.float32 and bool((v == 1).all())
             and v.numel() > 0}
    return names, sorted(last_axis.values()), {k: torch_leaves[k].shape for k in names}


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("config", ["full", "small"])
def test_param_sharding_matches_jax(config, model):
    cfg = {} if config == "full" else SMALL
    jnames, jlast, jshapes = _jax_sharded_names(cfg, model)
    port = UmeTrackNet(ModelConfig(**cfg))
    rule = param_sharding(Mesh(data=1, rank=0, model=model))
    names = {n for n, p in port.state_dict().items() if rule(n, p)}
    assert names == jnames
    # dim 0 of each sharded torch weight is the JAX kernel's last axis
    assert sorted(port.state_dict()[n].shape[0] for n in names) == jlast
    assert all(port.state_dict()[n].shape == jshapes[n] for n in names)
    if (config, model) == ("full", 2):
        assert len(names) == 44
        assert "backbone.stem_conv.weight" not in names and "regressor_u.conv_out.weight" not in names
    sizes = {n: rule(n, p) for n, p in port.state_dict().items()}
    assert all(spec == () for n, spec in sizes.items() if n not in names)


@pytest.mark.parametrize("model_axis", [1, 2, 0])
@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_mesh_layout_matches_jax(world, model_axis):
    import jax
    from umetrack_tpu.parallel.mesh import make_mesh as jmake_mesh

    devices = jax.devices()[:world]
    try:
        jmesh = jmake_mesh(devices, model_axis=model_axis)
    except AssertionError:
        with pytest.raises(ValueError, match="does not divide"):
            mesh_shape(world, model_axis)
        return
    ids = np.vectorize(lambda d: devices.index(d))(jmesh.devices)
    data, model = mesh_shape(world, model_axis)
    assert (data, model) == (jmesh.shape["data"], jmesh.shape["model"])
    for rank in range(world):
        mesh = Mesh(data=data, rank=rank, model=model)
        assert ids[mesh.data_index, mesh.model_index] == rank


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    """Starts the four ranks, computes the JAX (2, 2) mesh's and the one-process
    port's references while they run, then collects the ranks' results."""
    out = str(tmp_path_factory.mktemp("tp"))
    prepare_crops(os.path.join(out, "crops.pt"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r), str(port), out],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        refs = {"jax": jax_mesh_references(), "one": one_process_references(out)}
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return dict(ranks=ranks, out=out, **refs)


def one_process_references(out):
    mesh = make_mesh()
    return {"steps": run_steps(mesh), "eval": run_eval(mesh),
            "same_crops": run_same_crops(mesh, os.path.join(out, "crops.pt"))}


def jax_mesh_references():
    """The JAX package's train steps (loss and metrics) and batched evals on
    a (data 2, model 2) mesh of virtual CPU devices, from the port's seeded
    weights and the same numpy inputs."""
    import jax
    import jax.numpy as jnp
    import optax
    from umetrack_tpu.kinematics.hand import from_dict as jfrom_dict, load_hand_model_json
    from umetrack_tpu.models import make_model as jmake_model
    from umetrack_tpu.models.config import ModelConfig as JModelConfig
    from umetrack_tpu.parallel import eval as jeval, train as jtrain
    from umetrack_tpu.parallel.mesh import make_mesh as jmake_mesh, shard_batch as jshard_batch
    from umetrack_tpu.parallel.mesh import shard_variables as jshard_variables
    from umetrack_tpu.tracker import TrackerConfig as JTrackerConfig
    from umetrack_tpu.utils import synthetic as jsynthetic
    from conftest import GENERIC_HAND_JSON

    mesh = jmake_mesh(jax.devices()[:WORLD], model_axis=MODEL)
    assert dict(mesh.shape) == {"data": DATA, "model": MODEL}
    jmodel = jmake_model(JModelConfig(**SMALL))
    seeded = init_train_model(ModelConfig(**SMALL), seed=0, device="cpu").state_dict()
    variables = jshard_variables(jax.tree_util.tree_map(jnp.asarray, to_flax_variables(seeded)), mesh)

    jhand = jfrom_dict(load_generic_hand_dict())
    frame = jtrain.synthetic_train_batch(BATCH_SEED, B, jhand)
    frame = dataclasses.replace(frame, valid=jnp.asarray(VALID))
    draws = [jtrain.synthetic_train_batch(BATCH_SEED + 10 + k, B, jhand) for k in range(K)]

    def stack(get):
        return jnp.asarray(np.stack([np.asarray(get(d)) for d in draws], axis=1))

    extr = np.repeat(np.asarray(draws[0].frame.extrinsics)[:, None], K, axis=1).copy()
    extr[..., :3, 3] += 0.01 * np.arange(K, dtype=np.float32)[None, :, None, None]
    rep = lambda a: jnp.asarray(np.repeat(np.asarray(a)[:, None], K, axis=1))  # noqa: E731
    window = jtrain.TemporalTrainBatch(
        frames=jtrain.FrameInputs(
            images=stack(lambda d: d.frame.images), intrinsics=rep(draws[0].frame.intrinsics),
            extrinsics=jnp.asarray(extr), n_views=rep(draws[0].frame.n_views),
            hand_idx=rep(draws[0].frame.hand_idx),
            use_memory=jnp.asarray(np.broadcast_to(np.arange(K) > 0, (B, K)).copy()),
        ),
        skeleton=draws[0].skeleton, gt_joint_angles=stack(lambda d: d.gt_joint_angles),
        gt_wrist_world=stack(lambda d: d.gt_wrist_world), hand=draws[0].hand,
        gt_scales=draws[0].gt_scales, valid=jnp.asarray(VALID_T),
    )
    optimizer = optax.sgd(LR)
    steps = {}
    for name, step_fn, batch in (("train_step", jtrain.train_step, frame),
                                 ("temporal_train_step", jtrain.temporal_train_step, window)):
        ts = jtrain.create_train_state(variables, optimizer)
        _, metrics = step_fn(jmodel, optimizer, ts, jshard_batch(batch, mesh))
        steps[name] = {k: float(v) for k, v in metrics.items()}

    parts = [jsynthetic.our_sequence(labels, images) for labels, images in eval_labels()]
    rigs, seqs, hands = (jax.tree_util.tree_map(lambda *a: jnp.stack(a), *[p[k] for p in parts])
                         for k in range(3))
    cfg = JTrackerConfig()
    state = jeval.make_batched_state(jmodel, S)
    known = jeval.eval_sequences_batched(jmodel, cfg, variables,
                                         *jeval.shard_eval_inputs(mesh, rigs, seqs, state, hands))
    rigs_s, seqs_s, _, hands_s = jeval.shard_eval_inputs(mesh, rigs, seqs, state, hands)
    unknown = jeval.eval_sequences_unknown_batched(
        jmodel, cfg, variables, rigs_s, seqs_s, hands_s, load_hand_model_json(GENERIC_HAND_JSON),
        n_calibration_samples=N_CALIBRATION)
    to_np = lambda xs: [np.asarray(x, np.float64) for x in xs]  # noqa: E731
    return {"steps": steps, "eval": {"known": to_np(known), "unknown": to_np(unknown)}}


def test_worker_meshes(workers):
    for rank, res in enumerate(workers["ranks"]):
        shape, d, m, (data_ranks, model_ranks) = res["mesh"]
        assert shape == {"data": DATA, "model": MODEL} and (d, m) == (rank // MODEL, rank % MODEL)
        assert model_ranks == [d * MODEL + j for j in range(MODEL)]  # a run of consecutive ranks
        assert data_ranks == [j * MODEL + m for j in range(DATA)]  # strided
        assert res["app"]["mesh"] == {"data": DATA, "model": MODEL}


def test_collectives(workers):
    for rank, res in enumerate(workers["ranks"]):
        c = res["collectives"]
        d = rank // MODEL
        want = torch.cat([torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * (d * MODEL + j)
                          for j in range(MODEL)], dim=1)
        assert torch.equal(c["y"], want)
        w = torch.arange(2 * 3 * MODEL, dtype=torch.float32).reshape(2, 3 * MODEL)
        # each rank's slice of the gathered gradient, then summed by the copy's backward
        assert torch.equal(c["x_grad"], sum(w[:, 3 * j:3 * j + 3] for j in range(MODEL)))
        bf = torch.cat([(torch.arange(4) + 0.5 * (d * MODEL + j)).to(torch.bfloat16) / 3 for j in range(MODEL)])
        assert c["bf16"].dtype == torch.bfloat16 and torch.equal(c["bf16"], bf)


@pytest.mark.parametrize("name", STEPS)
def test_tp_train_step_matches_jax_mesh(workers, name):
    want = workers["jax"]["steps"][name]
    for res in workers["ranks"]:
        got = res["steps"][name]["metrics"]
        assert set(got) == set(want)
        for key, value in want.items():
            assert abs(got[key] - value) <= LOSS_RTOL * abs(value) + 1e-7, (key, got[key], value)


@pytest.mark.parametrize("name", STEPS)
def test_tp_train_step_matches_one_process(workers, name):
    ref = workers["one"]["steps"][name]
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref["grads"].values())))
    assert ref["norm"] > CLIP  # the clip engaged, so the gradients below are clipped ones
    for res in workers["ranks"]:
        got = res["steps"][name]
        assert abs(got["norm"] - ref["norm"]) <= NORM_RTOL * ref["norm"], (got["norm"], ref["norm"])
        for key, want in ref["metrics"].items():
            assert abs(got["metrics"][key] - want) <= LOSS_RTOL * abs(want) + 1e-7, key
        for leaf, want in ref["grads"].items():
            g = got["grads"][leaf]
            assert g.shape == want.shape, leaf
            if leaf in ZERO_GRAD_LEAVES:
                assert max(float(g.norm()), float(want.norm())) <= ZERO_GRAD_NOISE * total, leaf
                continue
            bound = FIRST_LAYERS_REL_L2 if leaf.startswith(FIRST_LAYERS) else GRAD_REL_L2
            assert float((g - want).norm() / want.norm()) <= bound, leaf
        for key, want in ref["stats"].items():
            np.testing.assert_allclose(got["stats"][key].numpy(), want.numpy(), rtol=STATS_TOL, atol=STATS_TOL,
                                       err_msg=key)


@pytest.mark.parametrize("name", STEPS)
def test_tp_updated_weights(workers, name):
    """The updated weights, gathered: each leaf's update against the one
    process's within the gradient bound, and the replicated leaves equal bit
    for bit over the ranks of each model group."""
    before = init_train_model(ModelConfig(**SMALL), seed=0, device="cpu").state_dict()
    ref = workers["one"]["steps"][name]["weights"]
    ranks = workers["ranks"]
    sharded = set(ranks[0]["app"]["sharded"])
    assert len(sharded) == 20
    for res in ranks:
        got = res["steps"][name]["weights"]
        for leaf, want in ref.items():
            if leaf in ZERO_GRAD_LEAVES:  # Adam normalises their rounding noise: |update| <= lr
                assert float((got[leaf] - before[leaf]).abs().max()) <= LR * (1 + 1e-3), leaf
                continue
            step, want_step = got[leaf] - before[leaf], want - before[leaf]
            bound = FIRST_LAYERS_REL_L2 if leaf.startswith(FIRST_LAYERS) else GRAD_REL_L2
            assert float((step - want_step).norm() / want_step.norm()) <= bound, leaf
    for d in range(DATA):
        group = [ranks[d * MODEL + j]["steps"][name]["weights"] for j in range(MODEL)]
        for leaf in ref:
            if leaf not in sharded:
                assert all(torch.equal(group[0][leaf], other[leaf]) for other in group[1:]), leaf


@pytest.mark.parametrize("protocol", ["known", "unknown"])
def test_tp_eval_matches_jax_mesh(workers, protocol):
    want = workers["jax"]["eval"][protocol]
    for res in workers["ranks"]:
        got = [x.double().numpy() for x in res["eval"][protocol]]
        assert got[0].shape == (S,)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], atol=JAX_EVAL_MM_TOL)
        np.testing.assert_allclose(got[2], want[2], rtol=EVAL_RTOL)
        if protocol == "unknown":
            np.testing.assert_allclose(got[3], want[3], atol=SCALE_TOL)


@pytest.mark.parametrize("protocol", ["known", "unknown"])
def test_tp_eval_matches_one_process(workers, protocol):
    want = [x.double().numpy() for x in workers["one"]["eval"][protocol]]
    assert (want[1] > 0).all()
    for res in workers["ranks"]:
        got = [x.double().numpy() for x in res["eval"][protocol]]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=EVAL_RTOL, atol=EVAL_MM_TOL)
        np.testing.assert_allclose(got[2], want[2], rtol=EVAL_RTOL)
        if protocol == "unknown":
            np.testing.assert_allclose(got[3], want[3], rtol=EVAL_RTOL, atol=1e-6)


def _scan_errors(first, angles, wrists, valid):
    """Per-sequence mean landmark errors (mm, as ``eval_sequences_batched``
    computes them) and the tracked landmarks of a scan whose rows start at
    sequence ``first``."""
    _, seqs, hands = eval_inputs()
    errors, landmarks = [], []
    for j in range(angles.shape[1] // 2):
        i, rows = first + j, slice(2 * j, 2 * j + 2)
        hand = hands.map(lambda a: a[i])
        tracked = sequence_landmarks(hand, angles[:, rows], wrists[:, rows])
        gt = sequence_landmarks(hand, seqs.gt_joint_angles[i], seqs.gt_wrist_xfs[i])
        err = torch.linalg.vector_norm(tracked - gt, dim=-1).mean(dim=-1)
        v = valid[:, rows].to(err.dtype)
        errors.append(float((err * v).sum() / v.sum().clamp(min=1.0)))
        landmarks.append(tracked)
    return np.array(errors), torch.stack(landmarks)


def test_tp_scan_on_the_same_crops_matches_one_process(workers):
    """Crops prepared once with no group: each rank's ``_model_scan`` of
    its data block's rows against the one process's scan of all rows, at the
    sharded-eval bounds: what the model and data axes do to the recurrent
    model alone, with the crop fit taken out."""
    first, *want = workers["one"]["same_crops"]
    assert first == 0
    want_errors, want_landmarks = _scan_errors(0, *want)
    assert want[2].any() and np.isfinite(want_errors).all()
    for rank, res in enumerate(workers["ranks"]):
        first, angles, wrists, valid = res["same_crops"]
        assert first == (rank // MODEL) * (S // DATA) and angles.shape[1] == 2 * S // DATA
        rows = slice(2 * first, 2 * first + angles.shape[1])
        assert torch.equal(valid, want[2][:, rows])
        errors, landmarks = _scan_errors(first, angles, wrists, valid)
        np.testing.assert_allclose(errors, want_errors[first:first + len(errors)], rtol=EVAL_RTOL,
                                   atol=EVAL_MM_TOL)
        np.testing.assert_allclose(landmarks.numpy(), want_landmarks[first:first + len(errors)].numpy(),
                                   atol=EVAL_MM_TOL)


def test_tp_train_app_checkpoint_reloads_unsharded(workers):
    """``main`` with ``{"mesh": {"model_axis": 2}}``: the orbax directory
    ``final`` holds the whole model (what the ranks gather), and one process
    with no group reloads it to the sharded model's forward."""
    from umetrack_torch.utils.checkpoints import load_checkpoint

    ranks = workers["ranks"]
    for res in ranks:
        assert len(res["app"]["history"]) == APP_STEPS and all(np.isfinite(res["app"]["history"]))
    assert os.listdir(os.path.join(workers["out"], "ckpt")) == ["final"]
    loaded = load_checkpoint(os.path.join(workers["out"], "ckpt", "final"), ModelConfig(**SMALL))
    gathered = ranks[0]["app"]["weights"]
    assert set(loaded) >= {k for k in gathered if "num_batches" not in k}
    for k, v in loaded.items():
        assert torch.equal(v, gathered[k].to(v.dtype)), k
    model = UmeTrackNet(ModelConfig(**SMALL))
    model.load_state_dict(loaded)
    alone = forward(model)
    for res in ranks:
        for key, want in alone.items():
            np.testing.assert_allclose(res["app"]["forward"][key].numpy(), want.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=key)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
