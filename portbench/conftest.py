"""pytest settings of the benchmark's own tests (``python -m pytest portbench/tests``): the
checkout's root on the path, and the ``card`` marker for tests that need an NVIDIA card,
which skip, decided inside the ``card`` fixture, where CUDA is not available."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips where CUDA is not available")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available here")
    return torch.device("cuda", 0)
