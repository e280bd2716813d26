"""Tests of the benchmark itself, on the CPU: ``python -m pytest
perfbench/tests -q`` from the root of a checkout. A test that needs a CUDA
GPU carries the ``card`` marker and skips without one (decided inside the
test); run those on a machine with the card."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA GPU")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")
