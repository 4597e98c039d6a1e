"""The harness on the CPU: the files resolve, the names keep the contract's
alphabet, each cell rehearses end to end at a tiny size, and nothing the
harness or the reference imports is the JAX package or JAX.

Run: ``python -m pytest portbench/tests -q`` from the checkout's root.
"""
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

ROOT = os.path.dirname(harness.HERE)
BENCHMARK = harness.load_json(ROOT, "BENCHMARK.json")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = harness.FORBIDDEN
SMALL = dict(start_planes=8, backbone_blocks=[1, 1, 1, 1], n_image_feature_channels=12,
             n_memory_channels=6)
# each cell's traffic cut to a few rendered frames (the CPU renders ~2 s a frame)
TINY = {
    "batched": dict(sequences=2, frames=3, frames_per_call=2, calls=[[0, 1], [2, -1]],
                    check_calls=1, n_calibration_samples=3),
    "stream": dict(frames=3, check_frames=2),
    "train": dict(sequences=2, frames=3, seqs_per_batch=2, window=3),
}


def tiny_overrides(cell: str) -> dict:
    """A few rendered frames; the tracking cells keep their model and
    weights (the checkpoint's answers differ from row to row, as a fault
    must be seen to change them), the train cell a small model."""
    spec = harness.load_cell(cell)
    config = harness.load_config(spec["config"])
    overrides = dict(cell={"traffic": {**spec["traffic"], **TINY[spec["entry"]]}})
    if spec["entry"] == "train":
        overrides["config"] = {"model": {**config["model"], **SMALL}}
    return overrides


def rehearse(cell: str, trace: bool = False, seed: int = 2**31 + 3) -> dict:
    ctx = harness.context(cell, seed, 1.0, trace, "cpu", time.perf_counter(), ROOT,
                          **tiny_overrides(cell))
    return harness.run_cell(ctx, BENCHMARK)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    entry = next(w for w in BENCHMARK["workloads"] if w["name"] == cell)
    spec = harness.load_cell(cell)
    assert entry["traffic"] == cell
    assert spec["config"] == entry["config"]
    assert os.path.exists(os.path.join(harness.HERE, "entries", f"{spec['entry']}.py"))
    config = next(c for c in BENCHMARK["configs"] if c["name"] == entry["config"])
    assert harness.load_json(ROOT, config["file"])["name"] == config["name"]
    assert spec["limits"]


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_resolves(metric):
    assert callable(harness.load_reader(metric))
    m = next(m for m in METRICS if m["name"] == metric)
    for cell in m.get("workloads", []):
        assert cell in CELLS


def test_names_and_units():
    names = [w["name"] for w in BENCHMARK["workloads"]] + [c["name"] for c in BENCHMARK["configs"]]
    names += [m["name"] for m in METRICS] + [w["traffic"] for w in BENCHMARK["workloads"]]
    names += [k for c in BENCHMARK["configs"] for k in c["reduced"]]
    for group in (BENCHMARK["workloads"], BENCHMARK["configs"], METRICS):
        assert len({g["name"] for g in group}) == len(group)
    for name in names:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCHMARK["workloads"]] + [m["layer"] for m in BENCHMARK["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in BENCHMARK["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCHMARK["end_to_end"])


def test_every_cell_reports_what_the_contract_asks():
    for cell in CELLS:
        e2e = [m["name"] for m in harness.metrics_of(BENCHMARK, cell, per_layer=False)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert harness.metrics_of(BENCHMARK, cell, per_layer=True), cell
        for m in harness.metrics_of(BENCHMARK, cell, per_layer=True):
            moved = next(e for e in BENCHMARK["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell]), (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cpu_rehearsal(cell, trace):
    torch.set_num_threads(2)
    result = rehearse(cell, trace)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"
    assert "busy_s" not in result["device"]
    device_metrics = {m["name"] for m in METRICS if m["source"] == "device_trace" or "mfu" in m["name"]}
    assert not device_metrics & set(result["metrics"])
    wanted = {m["name"] for m in harness.metrics_of(BENCHMARK, cell, per_layer=trace)}
    assert set(result["metrics"]) <= wanted
    if not trace:
        assert "setup_s" in result["metrics"]
    assert all(c["value"] == 0.0 for c in result["compared"].values())
    json.dumps(result, allow_nan=False)


def test_command_line_prints_one_result_line():
    """The benchmark's command line, on the CPU: the compared numbers
    are the last lines of standard error, the result the last of standard
    output, with ``compared`` its last key."""
    code = ("import sys, time; t=time.perf_counter(); sys.argv[0]='portbench'; "
            "from portbench import run; from portbench.tests import test_portbench_harness as t_; "
            "sys.exit(run.main(['--workload','known.stream','--seed','4294967301','--seconds','1',"
            "'--trace','0','--device','cpu'], t, **t_.tiny_overrides('known.stream')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "compared"
    tail = out.stderr.strip().splitlines()[-len(result["compared"]):]
    assert all(line.startswith("compared ") for line in tail)


def test_no_card_means_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _imported(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "; import sys, json; "
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    modules = ["portbench.run", "portbench.limits", "portbench.sides"] + [
        f"portbench.entries.{e}" for e in sorted({harness.load_cell(c)["entry"] for c in CELLS})]
    code = "; ".join(f"import {m}" for m in modules) + (
        "; from portbench import harness, sides; [harness.load_reader(m) for m in "
        "[m['name'] for k in ('end_to_end','per_layer') for m in harness.load_json('BENCHMARK.json')[k]]]"
        "; sides.side(sides.PROGRAM)")
    assert not _imported(code) & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    found = _imported("import portbench.reference.tracker, portbench.reference.models, "
                      "portbench.reference.kinematics, portbench.traffic, portbench.weights, "
                      "portbench.yardstick, portbench.compare")
    assert not found & (set(FORBIDDEN) | {"umetrack_torch"})
