"""A module-scoped fixture for the PyTorch port's CPU tests.

Under pytest-xdist (the suite runs with several workers) each worker's
torch would start one intra-op thread per core, so the workers' threads
outnumber the cores several times over and the tiny models' ops spend
their time waiting on one another: three tests of
tests/test_torch_port_serving_modes.py took 379 s in six processes at
once on 8 cores, 21 s with one thread each.  The fixture gives each
worker its share of the cores while a module runs and restores torch's
count after it; run without workers it changes nothing.  A test file
takes it with ``from port_threads import torch_threads_per_worker``.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
