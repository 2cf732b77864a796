"""One intra-op thread for the port's CPU tests.

The port's CPU paths run many small tensor ops (one or more per virtual
rank, stage and microbatch).  The suite runs under xdist, each worker
sharing the machine's cores with the others, and there PyTorch's default
OpenMP pool of one thread per core waits at every parallel region for
threads that another worker holds: a test that takes a second alone then
takes one to two minutes.  One thread a worker keeps each test near its
time alone.

A test module takes it with
``from torch_threads import one_torch_thread  # noqa: F401``: the
fixture is autouse, so it applies to every test of that module, and the
previous thread count comes back after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
