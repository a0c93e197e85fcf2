"""Shared by the port's CPU tests: one torch intra-op thread per process.

The test suite runs in several worker processes on one machine, and
torch's intra-op thread pool in each, sized to every core, oversubscribes
it: the plain versions' thousands of small ops then run several times
slower. Their integer results do not depend on the thread count.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
