"""A fixture the port's CPU test modules share (imported by name)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch ops on one intra-op thread. The suite runs
    several pytest workers on a few cores: small torch ops split over every
    core in each worker then wait on each other's threads (a float64 blend
    test took 0.08 s alone and 13-21 s in the parallel suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
