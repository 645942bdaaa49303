"""Fixtures of the benchmark's tests. Whether a card is there is decided
inside a fixture, never while a module is imported."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark measures only on one)")
    return torch.device("cuda", 0)
