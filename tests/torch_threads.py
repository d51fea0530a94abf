"""torch's intra-op threads for the port's test processes.

The tier-1 run spreads the test files over pytest-xdist workers, one process
each, and torch gives every process a pool of one thread per core. The
trainer, CLI and model-step tests run thousands of small ops, and with
every worker's pool on every core they wait on each other's barriers: a
3-step `cli.pretrain` of 2 layers took 2.6 s alone and did not end in 100 s
beside five more of itself, against 5.3-6.2 s each with one thread. So each
process takes its share of the cores, restored after each test.

A test file applies it to each of its tests by importing the fixture:

    from torch_threads import share_cores  # noqa: F401  (autouse)
"""

import os

import pytest
import torch


def core_share() -> int:
    """The cores of this machine over the xdist workers (1 when pytest runs
    without xdist), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(1, workers))


@pytest.fixture(autouse=True)
def share_cores():
    n = torch.get_num_threads()
    torch.set_num_threads(core_share())
    yield
    torch.set_num_threads(n)
