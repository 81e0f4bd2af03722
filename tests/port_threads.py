"""One torch intra-op thread while a port test file runs.

The suite runs six pytest workers on the CPU.  With torch's default of
one OpenMP thread per core in every worker, the workers' threads
oversubscribe the cores, and a port test that takes 1.8 s alone took
95-158 s inside the suite; with one thread each the port's files ran
in 91 s on 6 workers against 297 s.  Each port test file imports this
fixture (autouse), so it applies to that file's tests and fixtures and
restores the count afterwards.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
