"""pytest settings of the benchmark's own tests (``python -m pytest benchmark``).

The benchmark's directory and the repository root go on ``sys.path``, as
``benchmark/run.py`` puts them. Tests that need the card carry the ``card``
marker and take the ``cuda_device`` fixture, which skips inside the test when
there is none: nothing here decides at import time.
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the chip)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
