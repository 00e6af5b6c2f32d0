"""One intra-op thread for the port's CPU runs in a test module.

The fabric engines and the co-simulation run thousands of small PyTorch
operators a test on the CPU.  Where one of them is large enough for
PyTorch to split it over its thread pool (a ring runner's padded
streams, a matrix product), the pool's threads wait on one another, and
with the suite's parallel workers contending for the cores those waits
made a run up to 100x slower and burned the cores the other workers
needed.  The fabric's results are integers and the co-simulation's are
held within a tolerance, so the thread count changes no result.  A
module that imports ``one_intra_op_thread`` runs all its tests on one
thread; the count is restored after the module.
"""

import contextlib

import pytest
import torch


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    with one_thread():
        yield
