"""The comparison sees a broken program: each tracking cell rehearsed on
the CPU at a tiny size (the look for a card skipped), with a fault of
``portbench/faults.py`` planted in the program's entry, must come out
``correct: false``.  The training cell's faults are read on the card at the
cell's own size (``python -m portbench.limits --fault``)."""
import pytest
import torch

from portbench import faults, harness
from portbench.tests.test_portbench_harness import CELLS, rehearse

CASES = [(cell, fault) for cell in CELLS if harness.load_cell(cell)["entry"] != "train"
         for fault in faults.applicable(harness.load_cell(cell),
                                        harness.load_config(harness.load_cell(cell)["config"]))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault):
    torch.set_num_threads(2)
    with faults.plant(fault):
        result = rehearse(cell)
    assert result["correct"] is False, result["compared"]
