"""pytest settings of mzbench's own tests (``python -m pytest mzbench``)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (skips without one)")


@pytest.fixture
def card():
    """The CUDA device, or a skip where torch sees none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; torch sees none")
    return torch.device("cuda")
