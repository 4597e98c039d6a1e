"""Two processes over ``torch.distributed`` (gloo, on the CPU) reproduce one
process: ``parallel/distributed.py`` (``initialize``, ``shard_list_for_host``),
the sharded evaluation (``parallel/eval.py``: 2 ranks x 2 sequences against
one process on 4) and the sharded train steps (``train_step`` and
``temporal_train_step`` over 2 ranks against one process on the whole
batch: the synchronised BatchNorm, the global loss denominators and the
summed gradients).  The ranks hold different numbers of valid rows, so a
per-rank mean averaged over the ranks would fail.  This file runs itself as
the two workers (``--worker``) in subprocesses, with a timeout."""
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
from umetrack_torch.models import FrameInputs, ModelConfig  # noqa: E402
from umetrack_torch.parallel import distributed, eval as peval  # noqa: E402
from umetrack_torch.parallel import make_mesh, shard_batch, shard_variables  # noqa: E402
from umetrack_torch.parallel.optim import ClippedAdamW  # noqa: E402
from umetrack_torch.parallel.train import (  # noqa: E402
    TemporalTrainBatch,
    create_train_state,
    init_train_model,
    synthetic_train_batch,
    temporal_train_step,
    train_step,
)
from umetrack_torch.tracker import TrackerConfig  # noqa: E402
from umetrack_torch.tracker.types import CameraRig, FrameObservation  # noqa: E402
from umetrack_torch.utils.synthetic import make_labels_dict, our_sequence  # noqa: E402
from torch_threads import few_threads  # noqa: E402,F401  (autouse: two CPU threads)

WORLD = 2
SMALL = dict(
    start_planes=8, backbone_blocks=(1, 1, 1, 1),
    n_image_feature_channels=12, n_memory_channels=6,
)
S, T = 4, 3  # eval: 2 sequences a rank
B, K = 6, 4  # train: 3 rows a rank
# rank 0 holds 3 valid rows, rank 1 one; in the window rank 0 holds 11
# valid (row, frame) slots and rank 1 six
# The batches' seed: the comparison must measure the sharding, not a kink
# of the step (a pre-activation within f32 rounding of a ReLU's, which
# moves the one-process gradient itself past the bounds when the images
# move by an ulp).  With the seeded weights of flax's draw, random noise of
# one ulp (1e-7 relative) on the images moves the one-process gradients by
# up to 6.6 x the bounds (train_step) and 12.5 x (temporal) at seed 3, 7.8
# x (temporal) at 0; 7 is the first seed at which both steps stay under
# 1 % of the bounds (0.0074 x, 0.0064 x).
BATCH_SEED = 7
VALID = np.array([1, 1, 1, 1, 0, 0], bool)
VALID_T = np.ones((B, K), bool)
VALID_T[1, 3] = VALID_T[4] = VALID_T[5, 2:] = False
# tests/test_torch_train.py's bounds
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
FIRST_LAYERS_REL_L2 = 1e-2
FIRST_LAYERS = ("backbone.stem_", "backbone.stage0_block0.")
ZERO_GRAD_LEAVES = ("backbone.stem_conv.bias", "fusion.conv0.bias", "fusion.conv1.bias")
ZERO_GRAD_NOISE = 1e-5
STATS_TOL = 1e-5
EVAL_MM_TOL, EVAL_RTOL = 1e-3, 1e-4  # tests/test_parallel.py's sharded-eval bounds
TIMEOUT_S = 240


def _stack(trees, cls):
    return cls(**{k: torch.stack([getattr(tr, k) for tr in trees]) for k in trees[0].__dataclass_fields__})


def eval_inputs():
    parts = [our_sequence(*make_labels_dict(T, rng_seed=20 + i, render=False, device="cpu"), "cpu")
             for i in range(S)]
    return (_stack([p[0] for p in parts], CameraRig), _stack([p[1] for p in parts], FrameObservation),
            stack_hand_models([p[2] for p in parts]))


def train_batches():
    """A single-frame batch and a K-frame window of B rows (the window from
    K single-frame draws, the crop cameras drifting 1 cm a frame), with the
    valid masks above."""
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


def run_steps(perturb: bool = False):
    """{step name: (metrics, gradients, running stats)} after one step of
    each kind from seeded weights, on this process's block of the batch
    (the whole batch without a process group).  ``perturb`` spoils the
    weights first, which ``shard_variables`` must undo."""
    mesh = make_mesh()
    out = {}
    for name, (step_fn, batch) in train_batches().items():
        model = init_train_model(ModelConfig(**SMALL), seed=0, device="cpu")
        if perturb:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0.01)
        shard_variables(model, mesh)
        state = create_train_state(model, ClippedAdamW(model.parameters(), 1e-3, 1e-5))
        metrics = step_fn(state, shard_batch(batch, mesh))
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.clone() for n, p in model.named_parameters()},
                     {n: b.clone() for n, b in model.named_buffers() if "running" in n})
    return out


def run_eval():
    """(per-sequence error, valid slots, global mean) of the S sequences,
    each process evaluating its block."""
    rigs, seqs, hands = eval_inputs()
    model = init_train_model(ModelConfig(**SMALL), seed=0, device="cpu").eval()
    state = peval.make_batched_state(model, S, "cpu")
    rank, world = distributed.rank_and_world()
    if world > 1:
        rigs, seqs, state, hands = peval.shard_eval_inputs(rank, world, rigs, seqs, state, hands)
    return peval.eval_sequences_batched(model, TrackerConfig(), rigs, seqs, state, hands, device="cpu")


def worker(rank: int, port: int, out_path: str) -> None:
    torch.set_num_threads(1)
    got = distributed.initialize(f"localhost:{port}", WORLD, rank, device="cpu")
    try:
        result = {
            "initialize": list(got),
            "mesh": make_mesh().shape,
            "shard": distributed.shard_list_for_host([f"seq_{i}" for i in range(5)]),
            "eval": [torch.as_tensor(x).clone() for x in run_eval()],
            "steps": run_steps(perturb=rank == 1),
        }
    finally:
        distributed.finalize()
    torch.save(result, out_path)


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    paths = [str(out / f"rank{r}.pt") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(r), str(port),
                               paths[r]], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [torch.load(p, weights_only=True) for p in paths]


def test_initialize_and_shard_list_for_host(workers):
    assert distributed.initialize() == (0, 1) and not distributed.is_initialized()
    distributed.finalize()  # no group: nothing to leave
    assert distributed.shard_list_for_host([1, 2, 3]) == [1, 2, 3]
    names = [f"seq_{i}" for i in range(5)]
    for rank, res in enumerate(workers):
        assert res["initialize"] == [rank, WORLD]
        assert res["mesh"] == {"data": WORLD, "model": 1}
        assert res["shard"] == names[rank::WORLD]


def test_sharded_eval_matches_one_process(workers):
    err, n_valid, mean = run_eval()
    for res in workers:  # every rank returns the global results
        s_err, s_n, s_mean = res["eval"]
        assert s_err.shape == (S,)
        np.testing.assert_array_equal(s_n.numpy(), n_valid.numpy())
        np.testing.assert_allclose(s_err.numpy(), err.numpy(), rtol=EVAL_RTOL, atol=EVAL_MM_TOL)
        np.testing.assert_allclose(float(s_mean), float(mean), rtol=EVAL_RTOL)
    assert (n_valid > 0).all()


@pytest.fixture(scope="module")
def one_process():
    return run_steps()


@pytest.mark.parametrize("name", ["train_step", "temporal_train_step"])
def test_sharded_train_step_matches_one_process(workers, one_process, name):
    m_ref, g_ref, s_ref = one_process[name]
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in g_ref.values())))
    for res in workers:
        m, g, s = res["steps"][name]
        for key, want in m_ref.items():
            assert abs(m[key] - want) <= LOSS_RTOL * abs(want) + 1e-7, (key, m[key], want)
        for leaf, want in g_ref.items():
            if leaf in ZERO_GRAD_LEAVES:
                assert max(float(g[leaf].norm()), float(want.norm())) <= ZERO_GRAD_NOISE * total, leaf
                continue
            bound = FIRST_LAYERS_REL_L2 if leaf.startswith(FIRST_LAYERS) else GRAD_REL_L2
            rel = float((g[leaf] - want).norm() / want.norm())
            assert rel <= bound, (leaf, rel)
        for key, want in s_ref.items():
            np.testing.assert_allclose(s[key].numpy(), want.numpy(), rtol=STATS_TOL, atol=STATS_TOL,
                                       err_msg=key)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
