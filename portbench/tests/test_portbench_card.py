"""The comparison's control on the card: each cell run as the benchmark
runs it, at the cell's own size (a short window), with the program in the
precision below its configuration's (the configuration's ``control``: its
own bfloat16 path, or TF32 for float32), must come out ``correct: false``
on three seeds; the same run in the configured precision must come out
``correct: true``.

Run on the H100: ``python -m pytest portbench/tests -q -m card``.
"""
import time

import pytest

from portbench import harness
from portbench.tests.test_portbench_harness import BENCHMARK, CELLS, ROOT

SECONDS = 2.0
SEEDS = (3_141_592_653, 2_718_281_828, 1_414_213_562)


def run(cell, seed, control=False):
    ctx = harness.context(cell, seed, SECONDS, False, "cuda", time.perf_counter(), ROOT,
                          control=control)
    return harness.run_cell(ctx, BENCHMARK)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    for seed in SEEDS:
        result = run(cell, seed, control=True)
        assert result["correct"] is False, (seed, result["compared"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_configured_precision_is_correct(card, cell):
    result = run(cell, SEEDS[0])
    assert result["correct"] is True, result["compared"]
