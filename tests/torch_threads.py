"""One PyTorch intra-op thread while a port test runs.

Tier-1 runs the suite in six pytest workers on the CPU.  The port's
tensors are small, and at PyTorch's default of one intra-op thread per
core each worker's thread pool keeps the cores busy waiting for the
others: on an 8-core host, six copies of one engine test ran together in
552 s at 8 threads and in 26 s at 1, where one copy alone takes 22-24 s
at either count.  Every ``tests/test_torch_*.py`` imports
:func:`one_torch_thread`, an autouse fixture, so each of its tests runs at
one thread, and the count is put back after it.
"""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
