"""pytest settings of the benchmark's own tests (``pytest portbench/tests``):
the checkout's root on the path, and the ``chip`` marker for tests that need
a CUDA card (each decides inside a fixture and skips on the CPU)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is there (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
