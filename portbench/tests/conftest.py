"""The benchmark's own tests: ``python3 -m pytest portbench/tests -q`` (CPU);
on the card the tests marked ``card`` run as well (``-m card``)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU; skips without one (decided in a fixture)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control readings at the cells' own sizes run on the card")
    return torch.device("cuda", 0)
