"""The port's tracker bench (``umetrack_torch/bench.py``) against the JAX
package's ``bench.py`` on the CPU, at S=2 x T=2: the same workload (rigs,
sequences, hand models, the pipelined uint8 variants, the zero state), a
FLOP count that misses no convolution or dense layer, ``main``'s one JSON
line, and the refusals (no card without ``--device cpu``, a kernel sampler
on the CPU)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from umetrack_torch import bench
from umetrack_torch.models import ModelConfig
from umetrack_torch.tracker.tracker import track_sequences_batched
from umetrack_torch.tracker import TrackerConfig
from torch_threads import few_threads  # noqa: F401  (autouse: two CPU threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, T, DEPTH = 2, 2, 4
LEAF_TOL = 1e-6
FLOP_RTOL = 1e-3  # the counter against the hooks' count
FLOPS_PER_FRAME = 3.915e9  # ModelConfig() as the counter reads it on the CPU
FLOPS_PER_FRAME_RTOL = 1e-2
JSON_KEYS = ["metric", "value", "unit", "vs_baseline"]  # bench.py:286-291
MAIN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def jax_workload():
    """The JAX bench's inputs, built as ``bench.py:62-76, 122-125`` builds them."""
    from umetrack_tpu.models.config import ModelConfig as JModelConfig
    from umetrack_tpu.models.umetrack import TemporalState
    from umetrack_tpu.tracker import TrackState
    from umetrack_tpu.utils import synthetic

    labels, images = synthetic.make_labels_dict(T, rng_seed=0)
    rig, seq, hand = synthetic.our_sequence(labels, images)
    mcfg = JModelConfig(compute_dtype="bfloat16")
    stack = lambda x: jax.tree_util.tree_map(lambda a: jnp.stack([a] * S), x)  # noqa: E731
    rigs, hands, seqs = stack(rig), stack(hand), stack(seq)
    state = TrackState(temporal=TemporalState.zeros(2 * S, mcfg), valid_history=jnp.zeros((2 * S,), bool))
    return rigs, seqs, state, hands


@pytest.fixture(scope="module")
def port_workload():
    return bench.bench_inputs(T, S, "float32", torch.device("cpu"))


def _leaves(obj, names):
    return {n: getattr(obj, n) for n in names if getattr(obj, n) is not None}


def test_workload_equals_the_jax_bench(jax_workload, port_workload):
    jrigs, jseqs, jstate, jhands = jax_workload
    model, rigs, seqs, state, hands = port_workload
    for name, ours, ref in (("rig", rigs, jrigs), ("hand", hands, jhands)):
        fields = [f.name for f in dataclasses.fields(ours)]
        got = _leaves(ours, fields)
        assert got and set(got) == set(_leaves(ref, fields)), name
        for key, value in got.items():
            np.testing.assert_allclose(value.double().numpy(), np.asarray(getattr(ref, key), np.float64),
                                       rtol=LEAF_TOL, atol=LEAF_TOL, err_msg=f"{name}.{key}")
    for key in ("T_world_from_camera", "gt_joint_angles", "gt_wrist_xfs", "gt_confidences"):
        np.testing.assert_allclose(getattr(seqs, key).double().numpy(),
                                   np.asarray(getattr(jseqs, key), np.float64),
                                   rtol=LEAF_TOL, atol=LEAF_TOL, err_msg=key)
    # the images: the same hands drawn over noise that each package upsamples
    # with its own library (tests/test_torch_render.py holds the two renders)
    images, jimages = seqs.images.numpy(), np.asarray(jseqs.images)
    assert images.shape == jimages.shape == (S, T, 4, 480, 640) and images.dtype == jimages.dtype == np.uint8
    assert np.abs(images.astype(np.int16) - jimages.astype(np.int16)).mean() < 1.0
    assert (images[0] == images[1]).all()  # one sequence, stacked
    # the zero state: JAX's NHWC carry is the port's NCHW one
    assert tuple(state.temporal.mem_features.permute(0, 2, 3, 1).shape) == jstate.temporal.mem_features.shape
    assert tuple(state.temporal.prev_extrinsics.shape) == jstate.temporal.prev_extrinsics.shape
    assert tuple(state.valid_history.shape) == jstate.valid_history.shape
    assert not state.valid_history.any() and not state.temporal.mem_features.any()
    assert state.temporal.mem_features.dtype == model.config.torch_dtype == torch.float32


def test_variants_wrap_as_jax_uint8(port_workload):
    """``images + i + 1`` in uint8, bit for bit what ``jnp.uint8`` gives on
    the same images, wrap-around included."""
    images = port_workload[2].images
    edge = torch.arange(256, dtype=torch.uint8)
    for base in (images, edge):
        variants = bench.image_variants(base, DEPTH)
        assert len(variants) == DEPTH
        for i, v in enumerate(variants):
            want = np.asarray(jnp.asarray(base.numpy()) + jnp.uint8(i + 1))
            assert v.dtype == torch.uint8
            np.testing.assert_array_equal(v.numpy(), want)
    assert bench.image_variants(edge, DEPTH)[DEPTH - 1][255] == DEPTH - 1  # wrapped


def _hooked_flops(model, call):
    """2 (C_in / groups) C_out k_h k_w H_out W_out per image of every
    convolution, 2 in out per row of every dense layer, from forward hooks."""
    total = [0.0]

    def conv(module, inputs, out):
        c_in = module.in_channels // module.groups
        total[0] += 2.0 * c_in * module.out_channels * module.kernel_size[0] * module.kernel_size[1] * out.numel() \
            / module.out_channels

    def dense(module, inputs, out):
        total[0] += 2.0 * module.in_features * out.numel()

    handles = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else dense)
               for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        call()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def test_flop_count_is_complete(port_workload):
    model, rigs, seqs, state, hands = port_workload
    assert model.config == ModelConfig()

    def call():
        return track_sequences_batched(model, TrackerConfig(), rigs, seqs, state, hands, device="cpu")

    counted = bench.count_flops(call) / (S * T)
    hooked = _hooked_flops(model, call) / (S * T)
    assert abs(counted - hooked) <= FLOP_RTOL * hooked, (counted, hooked)
    assert abs(counted - FLOPS_PER_FRAME) <= FLOPS_PER_FRAME_RTOL * FLOPS_PER_FRAME, counted
    assert abs(hooked - FLOPS_PER_FRAME) <= FLOPS_PER_FRAME_RTOL * FLOPS_PER_FRAME, hooked


def test_main_prints_one_json_line():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    done = subprocess.run(
        [sys.executable, "-m", "umetrack_torch.bench", "--device", "cpu", "--seqs", str(S), "--t", str(T),
         "--no-reference"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=MAIN_TIMEOUT_S)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = done.stdout.strip().splitlines()
    assert len(lines) == 1, done.stdout
    result = json.loads(lines[0])
    assert list(result) == JSON_KEYS
    assert result["metric"] == "tracker_frames_per_s_per_chip" and result["unit"] == "frames/s"
    assert result["value"] > 0 and result["vs_baseline"] is None
    line = [ln for ln in done.stderr.splitlines() if ln.startswith("[bench]")]
    assert len(line) == 1, done.stderr[-3000:]
    assert f"S={S} T={T}" in line[0] and "sampler=auto(plain)" in line[0]
    assert "torch-counted 3.9" in line[0] and "% of" not in line[0] and line[0].endswith("[cpu]")
    assert "warp_pool 0" in line[0]  # the CPU takes the plain warp
    assert "reference baseline" not in done.stderr


def test_bench_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.bench_ours(T, S)


@pytest.mark.parametrize("sampler", ["kernel", "kernel_win", "kernel_full"])
def test_kernel_sampler_on_the_cpu_raises(sampler):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bench.main(["--sampler", sampler, "--device", "cpu", "--seqs", "1", "--t", "1"])


def test_peak_is_named_only_on_an_h100():
    assert bench.peak_flops("bfloat16", torch.device("cpu")) is None
    assert bench.card_name(torch.device("cpu")) == "cpu"
    with pytest.raises(SystemExit):
        bench.main(["--dtype", "float16", "--device", "cpu"])
