"""The benchmark's own tests. Tests that need a CUDA card take the ``card``
fixture (marked ``card``): it skips them, with a reason, on a host without
one. Run them on a card with ``python -m pytest hvdbench/tests -m card``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on a host without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port on "
                    "the GPU only")
    return torch.device("cuda", 0)
