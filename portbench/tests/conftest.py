"""The benchmark's tests: ``python -m pytest portbench/tests -q`` from the
checkout's root runs the CPU tests here and skips those marked ``card``;
on a machine with an H100, ``python -m pytest portbench/tests -q -m card``
runs those."""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (an H100); skips without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest portbench/tests -m card` on the H100")
    return torch.device("cuda")
