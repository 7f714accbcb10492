"""Tests of the benchmark harness. CPU tests run anywhere; tests marked
``cuda`` (the repository's marker for tests that need a card) skip without
one, decided inside the ``cuda_device`` fixture."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written kernels); "
        "skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
