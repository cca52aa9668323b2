"""Pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``).  Tests that need the card carry the ``gpu`` marker and
take the ``cuda_device`` fixture, which skips them where no card is
present; they decide that when they run, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skipped elsewhere)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)
