"""A fixture for the port's heavier test modules: the suite runs several
worker processes side by side, and PyTorch's CPU kernels would start a
thread per core in each of them and spend their time waiting on one another.
A module that imports ``few_threads`` runs its tests on two threads."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)
