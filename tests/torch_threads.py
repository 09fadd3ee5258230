"""One torch intra-op thread while a port test module runs.

The tier-1 command runs the suite in several worker processes on one host.
With torch's default of one OpenMP thread per core in each of them, the
workers oversubscribe the cores, and the spinning OpenMP threads slow every
test on the host, JAX tests included, by up to tens of times.  The port's
CPU tests use small tensors, which gain nothing from intra-op threads.

A test module opts in with ``from torch_threads import one_torch_thread``.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)
