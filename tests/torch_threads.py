"""One PyTorch intra-op thread for the port's CPU tests.

The whole suite runs in several pytest-xdist workers on one host, and
PyTorch's CPU kernels default to an OpenMP team of one thread per core in
every worker. The port's tests issue many small products, and the
workers' spinning thread teams then starve one another: six concurrent
runs of ``tests/test_torch_kernels.py -k geometry``, 10 s alone, had not
finished after 900 s with the default teams and took 8.4-9.4 s each with
one thread. Each port test module imports ``one_torch_thread`` (an
autouse fixture), which runs its tests on one intra-op thread and
restores the count after. No assertion changes.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
